"""The hand-written Hopper GEMM (``gemm``), its wrappers (``ops``) and plain oracles (``ref``)."""
