"""Host utilities of the port: the RNGs and the stage spans."""
