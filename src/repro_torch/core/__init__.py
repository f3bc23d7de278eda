"""TENET core semantics on tensors: TWD packing, ternary quantization, DAS, LPSA."""
