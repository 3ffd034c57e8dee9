"""Port of ``keystone_tpu.data``."""
