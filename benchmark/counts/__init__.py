"""Frozen work counts from a configuration's shapes: multiply-adds of the
networks (FLOPs = 2 x MACs) and the bytes and operations of the sampling
kernels; and the table of the device's peaks."""
