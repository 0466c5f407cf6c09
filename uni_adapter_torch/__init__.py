"""Uni-Adapter on PyTorch and CUDA (NVIDIA Hopper).

The port of `uni_adapter_tpu` to PyTorch: the same online test-time
adaptation of 3D vision-language models, with the TPU's Pallas kernels
rewritten by hand in CUDA C++ for `sm_90a` (`csrc/`).  It covers Uni3D
with the EVA02 trunk, OpenShape PPTA and ULIP-2 Point-BERT under MODE-DOTA
adaptation, entered through `python -m uni_adapter_torch.cli.tta`, and
their attention maps through `python -m
uni_adapter_torch.cli.extract_attention`; their CLIP text towers build
anchor banks (`python -m uni_adapter_torch.cli.build_anchors`), and
reference-layout torch checkpoints load into either (`models/loader.py`,
with its report `python -m uni_adapter_torch.models.loader`).  It serves
(`cli/serve.py`), pretrains (`cli/pretrain.py`), runs data-parallel over
torch.distributed (`parallel/`: `--dist-mode sharded|psum`, `--parallel
dp` under `python -m torch.distributed.run`) and compares clean and
corrupted attention across classes (`cli/cross_class.py`).

Importing the package, or any module in it, builds nothing: each CUDA
kernel is compiled by `nvcc` at its first launch (ops/build.py).
"""
__version__ = "0.1.0"
