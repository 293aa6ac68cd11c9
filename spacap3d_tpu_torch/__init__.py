"""PyTorch / CUDA port of spacap3d_tpu.

The eval forward (PointNet++ trunk, voting, proposals, spatiality-guided
captioner with KV-cached greedy decode) runs on an NVIDIA H100, with
hand-written CUDA kernels for furthest point sampling and ball query
(``csrc/``). CPU tensors take the kernels' plain PyTorch versions.
"""
