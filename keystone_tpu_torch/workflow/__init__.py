"""Port of ``keystone_tpu.workflow``."""
