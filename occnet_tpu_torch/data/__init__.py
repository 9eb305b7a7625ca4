"""Device-side input processing of the port."""
