"""A port model's weights as a checkpoint in the reference's published
layouts, for checking `uni_adapter_torch/models/loader.py` against models
whose weights are known.

    from scripts.reference_layouts import LAYOUTS, save
    save(LAYOUTS["uni3d"](model), "uni3d.pt")

  * `uni3d`: the Uni3D checkpoints' layout, with timm's fused EVA02 blocks
    (`point_encoder.visual.blocks.N.attn.qkv` with `q_bias`/`v_bias`,
    `mlp.w12`/`ffn_ln`/`w3`, rope buffers that the converter drops), the
    mini-PointNet as Conv1d/BatchNorm1d Sequentials, the pos-embed MLP as
    a Sequential;
  * `ulip`: ULIP-2's Point-BERT (`point_encoder.blocks.blocks.N`, fused
    `qkv`, a bare `pc_projection`);
  * `openshape`: OpenShape's PPTA (`ppat.sa.mlp_convs.N` as Conv2d,
    `ppat.lift.{0,2}`, `ppat.transformer.layers.N.{0,1}.fn...`, `proj`);
  * `clip_text`: open_clip's text tower (`text.transformer.resblocks.N`
    with `attn.in_proj_*`/`out_proj`, `mlp.c_fc`/`c_proj`,
    `text.text_projection` as a bias-free Linear, (E, W)).

Each function takes a port model (on any device) and returns its weights
as fp32 CPU tensors under the layout's names; `save` writes them with the
training-era `module.` prefix, as the reference's checkpoints carry it.
"""
from __future__ import annotations

import torch


def _t(x: torch.Tensor) -> torch.Tensor:
    return x.detach().to("cpu", torch.float32).clone()


def _linear(out: dict, key: str, dense, conv_rank: int = 2) -> None:
    w = _t(dense.weight)
    out[f"{key}.weight"] = w.reshape(*w.shape, *[1] * (conv_rank - 2))
    if dense.bias is not None:
        out[f"{key}.bias"] = _t(dense.bias)


def _ln(out: dict, key: str, ln) -> None:
    out[f"{key}.weight"] = _t(ln.weight)
    out[f"{key}.bias"] = _t(ln.bias)


def _bn(out: dict, key: str, bn) -> None:
    out[f"{key}.weight"] = _t(bn.scale)
    out[f"{key}.bias"] = _t(bn.bias)
    out[f"{key}.running_mean"] = _t(bn.mean)
    out[f"{key}.running_var"] = _t(bn.var)
    out[f"{key}.num_batches_tracked"] = torch.tensor(0)


def _mini_pointnet(out: dict, key: str, enc) -> None:
    _linear(out, f"{key}.first_conv.0", enc.conv1, 3)
    _bn(out, f"{key}.first_conv.1", enc.bn1)
    _linear(out, f"{key}.first_conv.3", enc.conv2, 3)
    _linear(out, f"{key}.second_conv.0", enc.conv3, 3)
    _bn(out, f"{key}.second_conv.1", enc.bn2)
    _linear(out, f"{key}.second_conv.3", enc.conv4, 3)


def uni3d(model) -> dict:
    pe, out = model.point_encoder, {}
    _mini_pointnet(out, "point_encoder.encoder", pe.encoder)
    _linear(out, "point_encoder.encoder2trans", pe.encoder2trans)
    _linear(out, "point_encoder.trans2embed", pe.trans2embed)
    out["point_encoder.cls_token"] = _t(pe.cls_token)
    out["point_encoder.cls_pos"] = _t(pe.cls_pos)
    _linear(out, "point_encoder.pos_embed.0", pe.pos_embed.fc1)
    _linear(out, "point_encoder.pos_embed.2", pe.pos_embed.fc2)
    for i, blk in enumerate(pe.blocks):
        k, a, m = f"point_encoder.visual.blocks.{i}", blk.attn, blk.mlp
        _ln(out, f"{k}.norm1", blk.norm1)
        _ln(out, f"{k}.norm2", blk.norm2)
        out[f"{k}.attn.qkv.weight"] = torch.cat(
            [_t(a.q_proj.weight), _t(a.k_proj.weight), _t(a.v_proj.weight)])
        out[f"{k}.attn.q_bias"] = _t(a.q_proj.bias)
        out[f"{k}.attn.v_bias"] = _t(a.v_proj.bias)
        _ln(out, f"{k}.attn.q_norm", a.q_norm)
        _ln(out, f"{k}.attn.k_norm", a.k_norm)
        _linear(out, f"{k}.attn.proj", a.proj)
        out[f"{k}.mlp.w12.weight"] = torch.cat(
            [_t(m.fc1_g.weight), _t(m.fc1_x.weight)])
        out[f"{k}.mlp.w12.bias"] = torch.cat(
            [_t(m.fc1_g.bias), _t(m.fc1_x.bias)])
        _ln(out, f"{k}.mlp.ffn_ln", m.norm)
        _linear(out, f"{k}.mlp.w3", m.fc2)
    hd = pe.blocks[0].attn.q_norm.weight.shape[0] if len(pe.blocks) else 64
    gen = torch.Generator().manual_seed(0)
    for name in ("freqs_cos", "freqs_sin"):       # inactive in the forward
        out[f"point_encoder.visual.rope.{name}"] = torch.randn(
            8, hd, generator=gen)
    _ln(out, "point_encoder.visual.norm", pe.norm)
    _ln(out, "point_encoder.visual.fc_norm", pe.fc_norm)
    return out


def ulip(model) -> dict:
    pe, out = model.point_encoder, {}
    _mini_pointnet(out, "point_encoder.encoder", pe.encoder)
    _linear(out, "point_encoder.reduce_dim", pe.reduce_dim)
    out["point_encoder.cls_token"] = _t(pe.cls_token)
    out["point_encoder.cls_pos"] = _t(pe.cls_pos)
    _linear(out, "point_encoder.pos_embed.0", pe.pos_embed.fc1)
    _linear(out, "point_encoder.pos_embed.2", pe.pos_embed.fc2)
    for i, blk in enumerate(pe.blocks):
        k = f"point_encoder.blocks.blocks.{i}"
        _ln(out, f"{k}.norm1", blk.norm1)
        _ln(out, f"{k}.norm2", blk.norm2)
        _linear(out, f"{k}.attn.qkv", blk.attn.qkv)
        _linear(out, f"{k}.attn.proj", blk.attn.proj)
        _linear(out, f"{k}.mlp.fc1", blk.mlp.fc1)
        _linear(out, f"{k}.mlp.fc2", blk.mlp.fc2)
    _ln(out, "point_encoder.norm", pe.norm)
    out["pc_projection"] = _t(model.pc_projection)
    return out


def openshape(model) -> dict:
    p, out = model.ppat, {}
    for i in range(p.sa.n_layers):
        _linear(out, f"ppat.sa.mlp_convs.{i}", getattr(p.sa, f"conv{i}"), 4)
        _bn(out, f"ppat.sa.mlp_bns.{i}", getattr(p.sa, f"bn{i}"))
    _linear(out, "ppat.lift.0", p.lift, 3)
    _ln(out, "ppat.lift.2", p.lift_norm)
    out["ppat.cls_token"] = _t(p.cls_token)
    for i, layer in enumerate(p.layers):
        k = f"ppat.transformer.layers.{i}"
        _ln(out, f"{k}.0.norm", layer.attn_norm)
        _linear(out, f"{k}.0.fn.to_qkv", layer.attn.qkv)
        _linear(out, f"{k}.0.fn.to_out.0", layer.attn.proj)
        if layer.pe is not None:
            _linear(out, f"{k}.0.fn.pe.0", layer.pe.fc1)
            _linear(out, f"{k}.0.fn.pe.2", layer.pe.fc2)
        _ln(out, f"{k}.1.norm", layer.ff_norm)
        _linear(out, f"{k}.1.fn.net.0", layer.ff.fc1)
        _linear(out, f"{k}.1.fn.net.3", layer.ff.fc2)
    _linear(out, "proj", model.proj)
    return out


def clip_text(tower) -> dict:
    out = {"text.token_embedding.weight": _t(tower.token_embedding),
           "text.positional_embedding": _t(tower.positional_embedding)}
    for i, blk in enumerate(tower.resblocks):
        k = f"text.transformer.resblocks.{i}"
        _ln(out, f"{k}.ln_1", blk.ln_1)
        out[f"{k}.attn.in_proj_weight"] = _t(blk.attn.qkv.weight)
        out[f"{k}.attn.in_proj_bias"] = _t(blk.attn.qkv.bias)
        _linear(out, f"{k}.attn.out_proj", blk.attn.proj)
        _ln(out, f"{k}.ln_2", blk.ln_2)
        _linear(out, f"{k}.mlp.c_fc", blk.mlp.fc1)
        _linear(out, f"{k}.mlp.c_proj", blk.mlp.fc2)
    _ln(out, "text.ln_final", tower.ln_final)
    out["text.text_projection.weight"] = _t(tower.text_projection).T.clone()
    return out


LAYOUTS = {"uni3d": uni3d, "ulip": ulip, "openshape": openshape,
           "clip_text": clip_text}


def save(state_dict: dict, path) -> None:
    """Write `state_dict` with the `module.` prefix (a path or a file)."""
    torch.save({f"module.{k}": v for k, v in state_dict.items()}, path)
