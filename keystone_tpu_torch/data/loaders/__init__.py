"""Port of ``keystone_tpu.data.loaders`` (CSV, TIMIT, text, CIFAR-10)."""
