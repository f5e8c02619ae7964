"""Model zoo of the port (dense decoder so far)."""
