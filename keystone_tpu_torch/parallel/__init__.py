"""Port of ``keystone_tpu.parallel``."""
