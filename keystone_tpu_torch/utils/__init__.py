"""Port of ``keystone_tpu.utils``."""
