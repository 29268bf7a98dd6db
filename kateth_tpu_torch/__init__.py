"""PyTorch and CUDA port of kateth_tpu for NVIDIA Hopper GPUs.

The KZG operations of `kateth_tpu_torch.kzg.Kzg` (batch and single-point
verification, commitments and proofs) run on the card through eight
hand-written CUDA kernels (see cuda_lib.py); every kernel has a plain
PyTorch version that CPU tensors take.
"""
