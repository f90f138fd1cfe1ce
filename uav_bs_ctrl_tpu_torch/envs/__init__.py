"""On-device environment (batched over worlds) and its NumPy map layouts."""
