"""Grid file I/O of the port: the text-grid codec and the host bit-packing."""
