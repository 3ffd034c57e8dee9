"""Port of ``keystone_tpu.evaluation``."""
