"""Small fixed-size linear algebra and tensor helpers."""

from outfit_tpu_torch.utils.linalg import cholesky6, cholesky_inverse6

__all__ = ["cholesky6", "cholesky_inverse6"]
