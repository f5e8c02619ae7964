"""Model zoo of the port (dense decoder and RWKV6 so far)."""
