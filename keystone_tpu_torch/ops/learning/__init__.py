"""Port of ``keystone_tpu.ops.learning``."""
