"""NumPy golden references (float32), the port's own copies."""
