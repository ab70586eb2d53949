"""Host utilities of the port: the RNGs."""
