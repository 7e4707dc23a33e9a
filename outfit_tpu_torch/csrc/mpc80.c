/* Source: outfit_tpu/native/mpc80.c (copied).
 *
 * Fast MPC 80-column astrometry parser (host code, not a device kernel): a
 * branch-light single-pass parser over the raw file buffer, writing straight
 * into caller-provided column arrays (struct-of-arrays).  Built with cc and
 * bound via ctypes (outfit_tpu_torch/observations/native.py); the Python
 * parser in observations/mpc80.py is the reference behaviour and the
 * fallback.
 *
 * Epoch conversion matches time/scales.py: days-from-civil (Howard Hinnant's
 * algorithm) + the IERS leap-second table + TT-TAI = 32.184 s.
 */

#include <math.h>
#include <stddef.h>
#include <string.h>

static const double LEAP_MJD[] = {
    41317, 41499, 41683, 42048, 42413, 42778, 43144, 43509, 43874, 44239,
    44786, 45151, 45516, 46247, 47161, 47892, 48257, 48804, 49169, 49534,
    50083, 50630, 51179, 53736, 54832, 56109, 57204, 57754};
static const double LEAP_SEC[] = {
    10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23,
    24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37};
static const int N_LEAP = 28;

static double tai_minus_utc(double mjd_utc) {
  int i;
  double s = LEAP_SEC[0];
  for (i = 0; i < N_LEAP; i++) {
    if (mjd_utc >= LEAP_MJD[i]) s = LEAP_SEC[i];
    else break;
  }
  return s;
}

/* days from civil date to 1970-01-01, then shifted to MJD (epoch 1858-11-17
 * = -40587 relative to unix epoch days) */
static long days_from_civil(long y, long m, long d) {
  long era, yoe, doy, doe;
  y -= m <= 2;
  era = (y >= 0 ? y : y - 399) / 400;
  yoe = y - era * 400;
  doy = (153 * (m + (m > 2 ? -3 : 9)) + 2) / 5 + d - 1;
  doe = yoe * 365 + yoe / 4 - yoe / 100 + doy;
  return era * 146097 + doe - 719468;
}

static int parse_int(const char *s, int len, long *out) {
  long v = 0;
  int i, seen = 0;
  for (i = 0; i < len; i++) {
    char c = s[i];
    if (c == ' ') { if (seen) break; else continue; }
    if (c < '0' || c > '9') return 0;
    v = v * 10 + (c - '0');
    seen = 1;
  }
  if (!seen) return 0;
  *out = v;
  return 1;
}

static int parse_float(const char *s, int len, double *out) {
  double v = 0.0, frac = 0.0, scale = 1.0;
  int i, seen = 0, in_frac = 0, neg = 0;
  for (i = 0; i < len; i++) {
    char c = s[i];
    if (c == ' ') { if (seen || in_frac) break; else continue; }
    if (c == '-') { neg = 1; continue; }
    if (c == '+') continue;
    if (c == '.') { in_frac = 1; continue; }
    if (c < '0' || c > '9') return 0;
    if (in_frac) { scale *= 0.1; frac += (c - '0') * scale; }
    else v = v * 10.0 + (c - '0');
    seen = 1;
  }
  if (!seen && !in_frac) return 0;
  *out = (neg ? -1.0 : 1.0) * (v + frac);
  return 1;
}

/* Parse the whole buffer.  Output arrays must hold >= n_lines entries.
 * ids/obscodes are fixed-width char blocks (12 and 3 bytes per record).
 * Returns the number of records parsed. */
long parse_mpc80(const char *buf, long buf_len, double *mjd_tt, double *ra,
                 double *dec, double *mag, char *ids, char *obscodes,
                 char *discovery, char *catalogs) {
  long n = 0;
  long pos = 0;
  const double DEG = 3.14159265358979323846 / 180.0;
  const double HOUR = 3.14159265358979323846 / 12.0;

  while (pos < buf_len) {
    long eol = pos;
    long len, i;
    const char *line;
    while (eol < buf_len && buf[eol] != '\n') eol++;
    line = buf + pos;
    len = eol - pos;
    pos = eol + 1;

    if (len < 56) continue;
    /* skip satellite/roving second lines */
    if (line[14] == 's' || line[14] == 'v' || line[14] == 'r' ||
        line[14] == 'R')
      continue;

    {
      long year, month;
      double day_frac, hh, mm, ss, dd, dmm, dss, sign;
      long days;
      double mjd_utc, ra_rad, dec_rad, m;
      char idbuf[12];
      int has_id = 0;

      /* trajectory id: cols 1-5 (number) else 6-12 (provisional) */
      memset(idbuf, ' ', 12);
      for (i = 0; i < 5 && i < len; i++)
        if (line[i] != ' ') { has_id = 1; break; }
      if (has_id) {
        memcpy(idbuf, line, 5);
      } else {
        for (i = 5; i < 12 && i < len; i++)
          if (line[i] != ' ') { has_id = 1; break; }
        if (!has_id) continue;
        memcpy(idbuf, line + 5, 7);
      }

      if (!parse_int(line + 15, 4, &year)) continue;
      if (!parse_int(line + 20, 2, &month)) continue;
      if (!parse_float(line + 23, 9, &day_frac)) continue;

      if (!parse_float(line + 32, 2, &hh)) continue;
      if (!parse_float(line + 35, 2, &mm)) continue;
      if (!parse_float(line + 38, 6, &ss)) continue;
      ra_rad = (hh + mm / 60.0 + ss / 3600.0) * HOUR;

      sign = (line[44] == '-') ? -1.0 : 1.0;
      if (!parse_float(line + 45, 2, &dd)) continue;
      if (!parse_float(line + 48, 2, &dmm)) continue;
      if (!parse_float(line + 51, 5, &dss)) continue;
      dec_rad = sign * (dd + dmm / 60.0 + dss / 3600.0) * DEG;

      days = days_from_civil(year, month, (long)day_frac);
      mjd_utc = (double)(days + 40587) + (day_frac - floor(day_frac));
      mjd_tt[n] = mjd_utc + (tai_minus_utc(mjd_utc) + 32.184) / 86400.0;

      m = NAN;
      if (len > 65) parse_float(line + 65, 5, &m);
      mag[n] = m;

      ra[n] = ra_rad;
      dec[n] = dec_rad;
      memcpy(ids + n * 12, idbuf, 12);
      if (len >= 80) memcpy(obscodes + n * 3, line + 77, 3);
      else memcpy(obscodes + n * 3, "500", 3);
      discovery[n] = (len > 12 && line[12] == '*') ? 1 : 0;
      /* col 72 (0-based 71): astrometric reference catalog code */
      catalogs[n] = (len > 71) ? line[71] : ' ';
      n++;
    }
  }
  return n;
}
