"""The train step of the port (one device; the multi-device steps wait for Slice F)."""
