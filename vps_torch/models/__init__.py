"""Models of the port (NCHW inside; NHWC at the detector's entry)."""
