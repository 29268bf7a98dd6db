"""EIP-4844 KZG commitments, proofs and their verification on PyTorch tensors."""

from ..host import KzgError
from .api import BYTES_PER_COMMITMENT, BYTES_PER_FIELD_ELEMENT, BYTES_PER_PROOF, Kzg
from .config import MAINNET, KzgConfig
from .setup import TorchSetup

__all__ = [
    "Kzg",
    "KzgConfig",
    "KzgError",
    "TorchSetup",
    "MAINNET",
    "BYTES_PER_COMMITMENT",
    "BYTES_PER_FIELD_ELEMENT",
    "BYTES_PER_PROOF",
]
