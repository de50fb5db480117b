"""Models of the frozen reference (NCHW inside; NHWC at the detector's
entry)."""
