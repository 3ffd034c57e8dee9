"""Port of ``keystone_tpu.ops.util``."""
