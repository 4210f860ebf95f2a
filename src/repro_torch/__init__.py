"""FROST serving on PyTorch and CUDA: the port of the ``repro`` package
to one NVIDIA H100.  Imports torch, numpy and the standard library only."""
