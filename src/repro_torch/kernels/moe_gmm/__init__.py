from .ops import expert_ffn, gmm
from .ref import reference_expert_ffn, reference_grouped_matmul

__all__ = ["expert_ffn", "gmm", "reference_expert_ffn", "reference_grouped_matmul"]
