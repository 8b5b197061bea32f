"""Carry parameters between the JAX package and the port.

The JAX `Trainer.params` pytree, as nested dicts/lists of numpy arrays
({"static", "dynamic", "pose", "fov"}), maps one to one onto the port's
parameter tree: the same keys, the same list order, the same layouts
([C, H, W] planes, [C, L] lines, [fan_in, fan_out] linear weights).
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree, device):
    """Nested dicts/lists of numpy arrays -> the port's parameters: f32 leaf
    tensors on `device` that require grad."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    return torch.tensor(np.asarray(tree, np.float32), device=device).requires_grad_(True)


def params_to_numpy(tree):
    """The port's parameters (or a gradient tree of the same shape) ->
    nested dicts/lists of numpy arrays (numpy leaves pass through)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to_numpy(v) for v in tree]
    if isinstance(tree, np.ndarray):
        return tree
    return tree.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# the preprocessing and LPIPS networks: JAX parameter trees -> the port's
# state dicts
# ---------------------------------------------------------------------------

def _t(x) -> torch.Tensor:
    """A leaf as a float32 tensor (numpy arrays are copied; tensors, meta
    ones among them, pass through)."""
    return x if isinstance(x, torch.Tensor) else torch.tensor(np.asarray(x, np.float32))


def _conv(sd, name, p):
    """HWIO kernel -> OIHW; ConvTranspose2d's [in, out, kh, kw], stored by
    the JAX package as [kh, kw, out, in], takes the same permutation."""
    sd[f"{name}.weight"] = _t(p["w"]).permute(3, 2, 0, 1).contiguous()
    if "b" in p:
        sd[f"{name}.bias"] = _t(p["b"])


def _linear(sd, name, p):
    sd[f"{name}.weight"] = _t(p["w"]).T.contiguous()
    sd[f"{name}.bias"] = _t(p["b"])


def raft_state_from_jax(params) -> dict:
    """rodynrf_tpu.preprocess.raft's parameter tree (init_raft_params or
    load_raft_torch_checkpoint, leaves as numpy) -> a state dict of the
    port's RAFT (undoing `_conv_p`'s OIHW -> HWIO). The fnet's instance
    norms have no affine in the reference; the JAX tree's scale and bias
    must be the identity."""
    sd = {}

    def norm(name, p, kind):
        if kind == "instance":
            for k, v in (("scale", 1.0), ("bias", 0.0)):
                if k in p and not torch.all(_t(p[k]) == v):
                    raise ValueError(f"{name}: the instance norm's {k} is not {v}; the "
                                     f"reference's InstanceNorm2d has no affine")
            return
        sd[f"{name}.weight"], sd[f"{name}.bias"] = _t(p["scale"]), _t(p["bias"])
        sd[f"{name}.running_mean"], sd[f"{name}.running_var"] = _t(p["mean"]), _t(p["var"])
        sd[f"{name}.num_batches_tracked"] = torch.tensor(0)

    for enc, kind in (("fnet", "instance"), ("cnet", "batch")):
        e = params[enc]
        _conv(sd, f"{enc}.conv1", e["conv1"])
        norm(f"{enc}.norm1", e["norm1"], kind)
        for li in (1, 2, 3):
            for bi in (0, 1):
                name, blk = f"{enc}.layer{li}.{bi}", e[f"layer{li}.{bi}"]
                _conv(sd, f"{name}.conv1", blk["conv1"])
                _conv(sd, f"{name}.conv2", blk["conv2"])
                norm(f"{name}.norm1", blk["norm1"], kind)
                norm(f"{name}.norm2", blk["norm2"], kind)
                if "downsample" in blk:
                    _conv(sd, f"{name}.downsample.0", blk["downsample"])
                    for n3 in ("norm3", "downsample.1"):  # one module, two names
                        norm(f"{name}.{n3}", blk["norm3"], kind)
        _conv(sd, f"{enc}.conv2", e["conv2"])
    u = params["update"]
    for n, p in u["encoder"].items():
        _conv(sd, f"update_block.encoder.{n}", p)
    for n, p in u["gru"].items():
        _conv(sd, f"update_block.gru.{n}", p)
    for n in ("flow_head.conv1", "flow_head.conv2", "mask.0", "mask.2"):
        _conv(sd, f"update_block.{n}", u[n])
    return sd


def dpt_state_from_jax(params, cfg) -> dict:
    """rodynrf_tpu.preprocess.dpt's parameter tree (init_dpt_params or
    load_dpt_torch_checkpoint) -> a state dict of the port's DPTDepthModel
    for `cfg` (undoing `_c`, `_ct`, `_lin`). The ViT's final norm, which
    the JAX tree does not carry and no depth path reads, is the identity."""
    sd = {}
    v = params["vit"]
    m = "pretrained.model"
    _conv(sd, f"{m}.patch_embed.proj", v["patch_embed"])
    sd[f"{m}.cls_token"] = _t(v["cls_token"])
    sd[f"{m}.pos_embed"] = _t(v["pos_embed"])
    for i in range(cfg.blocks):
        b, p = f"{m}.blocks.{i}", v[f"block{i}"]
        for n, key in (("norm1", "norm1"), ("norm2", "norm2")):
            sd[f"{b}.{n}.weight"], sd[f"{b}.{n}.bias"] = _t(p[key]["scale"]), _t(p[key]["bias"])
        _linear(sd, f"{b}.attn.qkv", p["qkv"])
        _linear(sd, f"{b}.attn.proj", p["proj"])
        _linear(sd, f"{b}.mlp.fc1", p["fc1"])
        _linear(sd, f"{b}.mlp.fc2", p["fc2"])
    like = sd[f"{m}.cls_token"]
    sd[f"{m}.norm.weight"] = torch.ones(cfg.dim, device=like.device)
    sd[f"{m}.norm.bias"] = torch.zeros(cfg.dim, device=like.device)
    for i in range(4):
        pp, p = f"pretrained.act_postprocess{i + 1}", params[f"post{i + 1}"]
        _linear(sd, f"{pp}.0.project.0", p["readout"])
        _conv(sd, f"{pp}.3", p["project"])
        if "resample" in p:
            _conv(sd, f"{pp}.4", p["resample"])
    for i in range(4):
        _conv(sd, f"scratch.layer{i + 1}_rn", params[f"layer{i + 1}_rn"])
        rf, p = f"scratch.refinenet{i + 1}", params[f"refinenet{i + 1}"]
        for unit, key in (("resConfUnit1", "rcu1"), ("resConfUnit2", "rcu2")):
            _conv(sd, f"{rf}.{unit}.conv1", p[key]["conv1"])
            _conv(sd, f"{rf}.{unit}.conv2", p[key]["conv2"])
        _conv(sd, f"{rf}.out_conv", p["out_conv"])
    for n, key in (("0", "head.conv1"), ("2", "head.conv2"), ("4", "head.conv3")):
        _conv(sd, f"scratch.output_conv.{n}", params[key])
    return sd


def lpips_state_from_jax(params, net: str) -> dict:
    """rodynrf_tpu.eval.lpips_jax's parameter tree (init_lpips_params or
    convert_lpips_state_dict, leaves as numpy) -> a state dict of the port's
    `eval.lpips.LPIPS(net)`: HWIO kernels -> OIHW, each lin vector ->
    [1, C, 1, 1], the scaling layer from the tree or, where it has none,
    the constants the JAX package then uses."""
    from ..eval.lpips import _SLICES, SCALE, SHIFT

    sd = {}
    conv_ids = [(s, i) for s, idxs in enumerate(_SLICES[net], 1) for i in idxs]
    if len(conv_ids) != len(params["convs"]):
        raise ValueError(f"{net}: {len(params['convs'])} convs, expected {len(conv_ids)}")
    for (s, i), p in zip(conv_ids, params["convs"]):
        _conv(sd, f"net.slice{s}.{i}", p)
    for k, w in enumerate(params["lins"]):
        sd[f"lin{k}.model.1.weight"] = _t(w).reshape(1, -1, 1, 1)
    for name, default in (("shift", SHIFT), ("scale", SCALE)):
        sd[f"scaling_layer.{name}"] = _t(params.get(name, default)).reshape(1, 3, 1, 1)
    return sd
