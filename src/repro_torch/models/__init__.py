"""Model zoo of the port: the dense decoder-only LM family."""
