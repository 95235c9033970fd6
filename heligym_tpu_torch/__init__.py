"""heligym_tpu_torch: the PyTorch/CUDA port of heligym_tpu.

Batched 6-DOF helicopter flight environments on torch tensors, with the whole
env step fused into one hand-written CUDA kernel (`ops/cuda/fused_step.py`).
Entry points run on the CUDA card unless the caller passes `device="cpu"`.
"""
