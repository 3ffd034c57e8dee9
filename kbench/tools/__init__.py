"""One-off measurements that set the benchmark's numbers (the control's
readings, the serving sweep); the benchmark's runs do not call them."""
