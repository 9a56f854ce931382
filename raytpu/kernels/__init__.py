"""Pallas kernels — the GPU hot path.

The reference's L0 HLSL kernel layer (SURVEY.md §1) rebuilt as a
Pallas-Triton kernel: raygen + intersection + scatter + bounce loop fused
into one engine over blocks of ray lanes (raytpu/kernels/megakernel.py).
"""
