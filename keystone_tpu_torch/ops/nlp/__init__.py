"""Port of ``keystone_tpu.ops.nlp``."""
