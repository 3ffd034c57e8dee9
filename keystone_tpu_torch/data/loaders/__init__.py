"""Port of ``keystone_tpu.data.loaders`` (CSV only so far)."""
