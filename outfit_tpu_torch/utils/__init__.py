"""Small fixed-size linear algebra and tensor helpers."""
