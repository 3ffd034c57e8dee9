"""Operation counts of one fit, per configuration, from its shapes."""
