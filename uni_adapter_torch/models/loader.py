"""Model loading: a backbone or text tower from a seed, with the weights of
a reference-layout torch checkpoint laid over it (mirror of
`uni_adapter_tpu/models/loader.py`).

The checkpoint side is the JAX package's converter, copied: unwrap
`module`/`state_dict`/`model` and strip `module.` (`load_torch_state_dict`),
split timm's fused EVA02 layouts and drop rope (`_expand_structural`),
rename the published layouts' fragments (`_RENAMES`), and emit flax leaf
paths (`convert_state_dict`):

  * Linear / Conv1d(k=1) / Conv2d(k=1) weight (out, in, …) → kernel (in, out)
  * a 1-D weight → scale (LayerNorm or BatchNorm: the match decides)
  * BatchNorm running_mean/running_var → mean/var
  * open_clip's `token_embedding.weight` stays (vocab, width); its
    `text_projection.weight` (E, W) becomes CLIP's bare (W, E) parameter.

The model side names every port parameter by its flax path
(`param_paths`): `blocks.3` → `blocks_3`, a Dense `weight` → `kernel`
(transposed), a LayerNorm `weight` → `scale`, BatchNorm keeps
mean/var/scale/bias, under the flax tree's top-level `params/`.  Matching
then runs the JAX package's longest-suffix rule (`_match_leaves`) in that
path space, so the same checkpoint key claims the same parameter in both
packages and the conversion report names the same entries.

    python -m uni_adapter_torch.models.loader CKPT --vlm3d uni3d \
        [--text-preset ulip] [--eva-depth N] [--device cuda|cpu]

prints the report and `STRICT OVERLAY: CLEAN` (exit 0) or `STRICT OVERLAY:
DIFFS FOUND` (exit 1).
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import re
from types import SimpleNamespace
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from uni_adapter_torch.models.common import LN, Dense
from uni_adapter_torch.models.pointbert import create_ulip
from uni_adapter_torch.models.ppta import create_openshape
from uni_adapter_torch.models.uni3d import create_uni3d

#: Model constructors by `--vlm3d`: create(cfg.model, device, seed=...).
BACKBONES = {"uni3d": create_uni3d, "ulip": create_ulip,
             "openshape": create_openshape}


def build_backbone(vlm3d: str, mc, device: torch.device | str,
                   seed: int = 0, checkpoint_path: Optional[str] = None):
    """The point backbone for `vlm3d` from the ModelConfig `mc`, on
    `device`, frozen: random weights from `seed`, then the checkpoint at
    `checkpoint_path` laid over them (`load_checkpoint`).

    Returns (model, num_group, group_size): where the transformer tokens
    sit spatially, for the on-pointcloud attention overlays (OpenShape's
    tokens sit on its set abstraction's FPS centres, the same FPS as
    `group_points`).
    """
    if vlm3d not in BACKBONES:
        raise ValueError(f"unknown vlm3d {vlm3d!r}")
    model = BACKBONES[vlm3d](mc, device, seed=seed)
    if checkpoint_path:
        load_checkpoint(model, checkpoint_path)
    if vlm3d == "ulip":
        return model, mc.num_group, mc.ulip_group_size
    if vlm3d == "openshape":
        return model, model.ppat.sa.npoint, model.ppat.sa.nsample
    return model, mc.num_group, mc.group_size


def load_checkpoint(model: nn.Module, path: str,
                    strict: bool = False) -> Dict[str, Any]:
    """Lay the torch checkpoint at `path` over `model`'s parameters;
    returns its conversion report."""
    return overlay(model, convert_state_dict(load_torch_state_dict(path)),
                   strict=strict)


def load_torch_state_dict(path) -> Dict[str, np.ndarray]:
    """A torch checkpoint (a path or a file object) as fp32 numpy, unwrapped
    from `module`/`state_dict`/`model` and with the `module.` prefix
    stripped.  It is unpickled in full (`weights_only=False`), as the JAX
    package loads it, so only load files you trust."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    for key in ("module", "state_dict", "model"):
        if isinstance(sd, dict) and key in sd and isinstance(sd[key], dict):
            sd = sd[key]
    out = {}
    for k, v in sd.items():
        if not hasattr(v, "numpy"):
            continue
        k = k.removeprefix("module.")
        out[k] = v.float().numpy()
    return out


#: torch name-fragment → flax name-fragment rewrites, applied in order.
_RENAMES = [
    # open_clip CustomTextCLIP wraps the text tower under `text.`
    (r"^text\.", ""),
    # mini-PointNet sequential indices → named layers (uni3d.MiniPointNet)
    (r"first_conv\.0\.", "conv1."), (r"first_conv\.1\.", "bn1."),
    (r"first_conv\.3\.", "conv2."),
    (r"second_conv\.0\.", "conv3."), (r"second_conv\.1\.", "bn2."),
    (r"second_conv\.3\.", "conv4."),
    # pos-embed MLP sequential → fc1/fc2 (uni3d.PosEmbedMLP)
    (r"pos_embed\.0\.", "pos_embed.fc1."), (r"pos_embed\.2\.", "pos_embed.fc2."),
    # timm EVA block list → flax module names
    (r"visual\.blocks\.(\d+)\.", r"blocks_\1."),
    (r"^blocks\.(\d+)\.", r"blocks_\1."),
    (r"blocks\.blocks\.(\d+)\.", r"blocks_\1."),   # ULIP TransformerEncoder
    # timm EVA separate-SwiGLU naming (w1=gate, w2=value, w3=out, ffn_ln=mid
    # LayerNorm); the fused `w12` variant is split in _expand_structural
    (r"mlp\.w1\.", "mlp.fc1_g."), (r"mlp\.w2\.", "mlp.fc1_x."),
    (r"mlp\.w3\.", "mlp.fc2."), (r"mlp\.ffn_ln\.", "mlp.norm."),
    # timm EVA final norms
    (r"visual\.norm\.", "norm."), (r"visual\.fc_norm\.", "fc_norm."),
    # CLIP text transformer resblocks (OpenAI / open_clip layout):
    # nn.MultiheadAttention packs [q;k;v] rows of in_proj exactly like the
    # fused qkv Dense's output columns, so a plain transpose suffices
    (r"transformer\.resblocks\.(\d+)\.", r"resblocks_\1."),
    (r"attn\.in_proj_", "attn.qkv."),
    (r"attn\.out_proj\.", "attn.proj."),
    (r"mlp\.c_fc\.", "mlp.fc1."), (r"mlp\.c_proj\.", "mlp.fc2."),
    # OpenShape PPTA (the reference's models/openshape/ppta.py layout)
    (r"sa\.mlp_convs\.(\d+)\.", r"sa.conv\1."),
    (r"sa\.mlp_bns\.(\d+)\.", r"sa.bn\1."),
    (r"lift\.0\.", "lift."), (r"lift\.2\.", "lift_norm."),
    (r"transformer\.layers\.(\d+)\.0\.norm\.", r"layers_\1.attn_norm."),
    (r"transformer\.layers\.(\d+)\.0\.fn\.to_qkv\.", r"layers_\1.attn.qkv."),
    (r"transformer\.layers\.(\d+)\.0\.fn\.to_out\.0\.", r"layers_\1.attn.proj."),
    (r"transformer\.layers\.(\d+)\.0\.fn\.pe\.0\.", r"layers_\1.pe.fc1."),
    (r"transformer\.layers\.(\d+)\.0\.fn\.pe\.2\.", r"layers_\1.pe.fc2."),
    (r"transformer\.layers\.(\d+)\.1\.norm\.", r"layers_\1.ff_norm."),
    (r"transformer\.layers\.(\d+)\.1\.fn\.net\.0\.", r"layers_\1.ff.fc1."),
    (r"transformer\.layers\.(\d+)\.1\.fn\.net\.3\.", r"layers_\1.ff.fc2."),
]


def _rename(key: str) -> str:
    for pat, rep in _RENAMES:
        key = re.sub(pat, rep, key)
    return key


def _expand_structural(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Published layouts that need splitting, not renaming.

    * timm EVA02 fused attention: `attn.qkv.weight` (3W, W) with separate
      `attn.q_bias` / `attn.v_bias` (k's bias is a zero buffer) → separate
      q/k/v projections.  Told apart by q_bias, so the CLIP text towers'
      fused qkv stays fused.
    * timm EVA02 fused SwiGLU: `mlp.w12.{weight,bias}` chunks into
      (gate, value) halves along the output dim (timm GluMlp's order).
    * rope buffers (`rope.freqs_*`) are dropped: the reference drives the
      EVA blocks as bare `blk(x)`, with rotary embeddings inactive.
    """
    out: Dict[str, np.ndarray] = {}
    for k, v in sd.items():
        if ".rope." in k or k.startswith("rope."):
            continue
        if k.endswith("attn.qkv.weight") \
                and k[: -len("qkv.weight")] + "q_bias" in sd:
            p = k[: -len("qkv.weight")]
            W = v.shape[0] // 3
            out[p + "q_proj.weight"] = v[:W]
            out[p + "k_proj.weight"] = v[W:2 * W]
            out[p + "v_proj.weight"] = v[2 * W:]
            continue
        if k.endswith("attn.q_bias"):
            out[k[: -len("q_bias")] + "q_proj.bias"] = v
            continue
        if k.endswith("attn.v_bias"):
            out[k[: -len("v_bias")] + "v_proj.bias"] = v
            continue
        if k.endswith("attn.k_bias"):      # persistent zero buffer variants
            continue
        if k.endswith("mlp.w12.weight") or k.endswith("mlp.w12.bias"):
            h = v.shape[0] // 2
            out[k.replace("w12", "fc1_g")] = v[:h]
            out[k.replace("w12", "fc1_x")] = v[h:]
            continue
        out[k] = v
    return out


def convert_state_dict(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Checkpoint arrays by flax leaf path ('a/b/kernel')."""
    out: Dict[str, np.ndarray] = {}
    for key, val in _expand_structural(sd).items():
        key = _rename(key)
        parts = key.split(".")
        leaf = parts[-1]
        prefix = "/".join(parts[:-1])
        if key.endswith("token_embedding.weight"):
            # an embedding table, not a Linear: stays (vocab, width)
            out[prefix] = val
            continue
        if key.endswith("text_projection.weight"):
            # open_clip stores the projection as a bias-free Linear (E, W);
            # the tower keeps CLIP's bare (W, E) parameter
            out[prefix] = val.T
            continue
        if leaf == "weight":
            if val.ndim == 2:                       # Linear
                out[f"{prefix}/kernel"] = val.T
            elif val.ndim in (3, 4):                # Conv k=1
                out[f"{prefix}/kernel"] = val.reshape(val.shape[0], -1).T
            elif val.ndim == 1:
                # LayerNorm or BatchNorm scale: the match decides
                out[f"{prefix}/scale"] = val
            else:
                out[f"{prefix}/weight"] = val
        elif leaf == "bias":
            out[f"{prefix}/bias"] = val
        elif leaf == "running_mean":
            out[f"{prefix}/mean"] = val
        elif leaf == "running_var":
            out[f"{prefix}/var"] = val
        elif leaf in ("num_batches_tracked",):
            continue
        else:
            out[f"{prefix}/{leaf}" if prefix else leaf] = val
    return out


def param_paths(model: nn.Module) -> list:
    """Each parameter of `model` as (flax path, its name in `model`,
    transposed, a holder of its flax shape), in the flax tree's leaf order
    (keys sorted at every level)."""
    modules = dict(model.named_modules())
    out = []
    for name, p in model.named_parameters():
        owner_name, _, leaf = name.rpartition(".")
        owner = modules[owner_name]
        transposed = isinstance(owner, Dense) and leaf == "weight"
        if transposed:
            leaf = "kernel"
        elif isinstance(owner, LN) and leaf == "weight":
            leaf = "scale"
        parts = []
        for seg in owner_name.split(".") if owner_name else []:
            if seg.isdigit():                # a list element: blocks.3
                parts[-1] = f"{parts[-1]}_{seg}"
            else:
                parts.append(seg)
        shape = tuple(p.shape[::-1]) if transposed else tuple(p.shape)
        out.append((["params", *parts, leaf], name, transposed,
                    SimpleNamespace(shape=shape)))
    out.sort(key=lambda t: t[0])
    return [("/".join(path), name, tr, holder)
            for path, name, tr, holder in out]


def _suffix_match(pstr: str, ckey: str) -> bool:
    # match only on full path-component boundaries so e.g. checkpoint key
    # 'norm/scale' cannot claim the model's 'fc_norm/scale' leaf
    return pstr == ckey or pstr.endswith("/" + ckey)


def _match_leaves(path_strs, converted: Dict[str, np.ndarray]):
    """For each model leaf, the longest suffix-matching checkpoint key with
    an identical shape; also name-matching keys whose shapes disagree."""
    matches = {}
    shape_mismatches = []
    for pstr, leaf in path_strs:
        hit, near = None, None
        for ckey, cval in converted.items():
            if _suffix_match(pstr, ckey):
                if cval.shape == tuple(leaf.shape):
                    if hit is None or len(ckey) > len(hit):
                        hit = ckey
                elif near is None or len(ckey) > len(near):
                    near = ckey
        if hit is not None:
            matches[pstr] = hit
        elif near is not None:
            shape_mismatches.append(
                (pstr, near, tuple(leaf.shape), converted[near].shape))
    return matches, shape_mismatches


def conversion_report(model: nn.Module,
                      converted: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """The strict-overlay diff of a converted checkpoint against `model`,
    under the flax names:

      converted:        {model leaf path: checkpoint key} that would load
      missing:          model leaves no checkpoint key covers (keep init)
      unexpected:       checkpoint keys no model leaf consumed
      shape_mismatches: (model path, ckpt key, model shape, ckpt shape)
                        where the name matches but the shape does not:
                        the usual symptom of a wrong dims config
    """
    return _report(param_paths(model), converted)


def _report(paths: list, converted: Dict[str, np.ndarray]) -> Dict[str, Any]:
    matches, shape_mismatches = _match_leaves(
        [(pstr, holder) for pstr, _, _, holder in paths], converted)
    used = set(matches.values())
    missing = [pstr for pstr, _, _, _ in paths if pstr not in matches]
    unexpected = sorted(set(converted) - used)
    return {"converted": matches, "missing": missing,
            "unexpected": unexpected, "shape_mismatches": shape_mismatches,
            "n_model_leaves": len(paths)}


@torch.no_grad()
def overlay(model: nn.Module, converted: Dict[str, np.ndarray],
            strict: bool = False) -> Dict[str, Any]:
    """Copy the matched checkpoint arrays into `model`'s parameters (each
    cast to the parameter's dtype, on its device); the rest keep their
    init.  Missing and unexpected keys are logged; with `strict` either
    raises.  Returns the conversion report."""
    paths = param_paths(model)
    report = _report(paths, converted)
    params = dict(model.named_parameters())
    for pstr, name, transposed, _ in paths:
        if pstr in report["converted"]:
            arr = converted[report["converted"][pstr]]
            params[name].copy_(torch.from_numpy(
                np.ascontiguousarray(arr.T if transposed else arr)))
    missing, unexpected = report["missing"], report["unexpected"]
    if missing:
        logging.info("overlay: %d params kept their init (e.g. %s)",
                     len(missing), missing[:5])
    if unexpected:
        logging.info("overlay: %d checkpoint keys unused (e.g. %s)",
                     len(unexpected), unexpected[:5])
    if strict and (unexpected or missing):
        raise ValueError(f"strict overlay failed: missing={missing[:10]}, "
                         f"unexpected={unexpected[:10]}")
    return report


def print_conversion_report(report: Dict[str, Any], max_items: int = 20):
    print(f"model leaves:      {report['n_model_leaves']}")
    print(f"converted:         {len(report['converted'])}")
    print(f"missing (init):    {len(report['missing'])}")
    print(f"unexpected (ckpt): {len(report['unexpected'])}")
    print(f"shape mismatches:  {len(report['shape_mismatches'])}")
    for title, items in (("MISSING", report["missing"]),
                         ("UNEXPECTED", report["unexpected"])):
        if items:
            print(f"-- {title} ({len(items)}) --")
            for it in items[:max_items]:
                print(f"  {it}")
            if len(items) > max_items:
                print(f"  ... and {len(items) - max_items} more")
    if report["shape_mismatches"]:
        print("-- SHAPE MISMATCHES --")
        for pstr, ckey, ms, cs in report["shape_mismatches"][:max_items]:
            print(f"  {pstr}: model {ms} vs checkpoint {ckey} {cs}")


def report_main(argv: Optional[Sequence[str]] = None) -> int:
    """`python -m uni_adapter_torch.models.loader CKPT --vlm3d uni3d`: the
    strict-overlay diff of a torch checkpoint against the selected model
    (fp32, random init), and whether it is clean."""
    from uni_adapter_torch.cli.tta import resolve_device
    from uni_adapter_torch.config import ModelConfig
    from uni_adapter_torch.models.clip_text import create_text_encoder

    ap = argparse.ArgumentParser(description=report_main.__doc__)
    ap.add_argument("checkpoint", help="torch checkpoint path (.pt)")
    ap.add_argument("--vlm3d", default="uni3d",
                    choices=["uni3d", "ulip", "openshape", "clip_text"])
    ap.add_argument("--text-preset", default="ulip",
                    help="clip_text tower preset "
                         "(ulip/uni3d/openshape_vitg14/openshape_vitl14)")
    ap.add_argument("--eva-depth", type=int, default=None)
    ap.add_argument("--max-items", type=int, default=20)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if args.vlm3d == "clip_text":
        model = create_text_encoder(args.text_preset, device, torch.float32)
    else:
        mc = ModelConfig(vlm3d=args.vlm3d, compute_dtype="float32")
        if args.eva_depth is not None:
            mc = dataclasses.replace(mc, eva_depth=args.eva_depth)
        model = BACKBONES[args.vlm3d](mc, device)

    converted = convert_state_dict(load_torch_state_dict(args.checkpoint))
    report = conversion_report(model, converted)
    print_conversion_report(report, max_items=args.max_items)
    ok = (not report["missing"] and not report["unexpected"]
          and not report["shape_mismatches"])
    print("STRICT OVERLAY:", "CLEAN" if ok else "DIFFS FOUND")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(report_main())
