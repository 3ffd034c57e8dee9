"""Port of ``keystone_tpu.ops.stats``."""
