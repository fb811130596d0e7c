"""The hand-written Hopper kernels (``gemm``, ``rmsnorm``, ``flash_attention``, built by ``_build``), their wrappers (``ops``) and plain oracles (``ref``)."""
