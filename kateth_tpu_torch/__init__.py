"""PyTorch and CUDA port of kateth_tpu for NVIDIA Hopper GPUs.

The batch blob-proof verification path (`kateth_tpu_torch.kzg.Kzg`) runs
on the card through five hand-written CUDA kernels (see cuda_lib.py); every
kernel has a plain PyTorch version that CPU tensors take.
"""
