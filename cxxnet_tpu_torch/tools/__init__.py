"""Dataset tools of cxxnet_tpu_torch (own copies of cxxnet_tpu/tools/'s
image packers)."""
