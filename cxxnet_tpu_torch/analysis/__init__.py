"""Source analysis of the port (counterpart of cxxnet_tpu/analysis/):
the config key registry behind the CLI's schema check."""
