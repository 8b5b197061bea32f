"""Shared tiny-shape fixtures for the port's tests and smoke runs.

The shapes are the JAX package's (rodynrf_tpu/testing.py), so a test can
build both packages from one command line and one scene and compare them.
"""

from __future__ import annotations

import contextlib

TINY = dict(T=4, H=16, W=16, batch=64, n_samples=16)


def tiny_cmd(ray_type: str = "ndc", optimize: int = 1, batch: int | None = None) -> str:
    b = batch if batch is not None else TINY["batch"]
    return (
        f"--expname tiny --datadir none --dataset_name synthetic "
        f"--n_iters 32 --batch_size {b} --N_voxel_t {TINY['T']} "
        f"--N_voxel_init 512 --N_voxel_final 1000 "
        f"--upsamp_list 8 --upsamp_list 12 --upsamp_list 16 --upsamp_list 20 "
        f"--nSamples {TINY['n_samples']} --step_ratio 2.0 --ray_type {ray_type} "
        f"--model_name TensorVMSplit_TimeEmbedding --shadingMode MLP_Fea_late_view "
        f"--shadingModeStatic MLP_Fea "
        f"--n_lamb_sigma 4 --n_lamb_sigma 2 --n_lamb_sigma 2 "
        f"--n_lamb_sh 8 --n_lamb_sh 4 --n_lamb_sh 4 "
        f"--fea2denseAct relu --view_pe 0 --fea_pe 0 "
        f"--TV_weight_density 0.1 --TV_weight_app 0.01 --L1_weight_inital 8e-5 "
        f"--distortion_weight_static 0.02 --distortion_weight_dynamic 0.005 "
        f"--optimize_poses {optimize} --optimize_focal_length {optimize} --use_disp 1 "
        f"--bf16 0"  # f32 tables: the parity tests compare at float tolerances
    )


def tiny_scene(ray_type: str = "ndc"):
    from .data import make_synthetic_scene

    return make_synthetic_scene(T=TINY["T"], H=TINY["H"], W=TINY["W"], ray_type=ray_type)


def inject_reference_init(trainer, golden_out: str):
    """Replace the trainer's random fields with the reference's own initial
    state dicts (`<golden_out>/init_{static,dynamic}.th`, recorded by
    golden/run_reference.py), with fresh optimizers: the start of the golden
    comparison (GOLDEN.md). The cameras keep the trainer's initial values."""
    import os

    import numpy as np

    from .train.checkpoints import import_th
    from .train.convert import params_to_numpy

    tree = params_to_numpy(trainer.params)
    for name in ("static", "dynamic"):
        ref, _ = import_th(os.path.join(golden_out, f"init_{name}.th"))
        for key in ref:
            if key not in tree[name]:
                raise KeyError(f"{name}: unknown parameter {key}")
        for i in range(3):
            a = np.asarray(ref["density_plane"][i]).shape
            b = tree[name]["density_plane"][i].shape
            if a != b:
                raise ValueError(f"{name} density_plane[{i}]: reference {a} vs the trainer's {b}")
        tree[name].update(ref)
    trainer.set_params(tree)


def golden_trainer(repo: str, device: str = "cpu"):
    """The golden comparison's trainer: `golden/tiny.txt` on the committed
    fixture, deterministic draws (golden_det), the reference's initial
    fields. Returns (trainer, scene)."""
    import os

    from .data.video_dataset import load_nvidia_scene
    from .train import Trainer, config_parser

    out = os.path.join(repo, "golden", "out")
    args = config_parser(["--config", os.path.join(repo, "golden", "tiny.txt"),
                          "--datadir", os.path.join(out, "fixture")])
    args.golden_det = 1
    scene = load_nvidia_scene(args.datadir, downsample=1.0, use_disp=True,
                              use_foreground_mask="motion_masks", with_gt_poses=True,
                              ray_type="ndc", device=device)
    trainer = Trainer(args, scene, device=device)
    inject_reference_init(trainer, out)
    return trainer, scene


def write_video_scene(root: str, T: int, H: int, W: int, seed: int = 0, layout: str = "nvidia",
                      fmt: str = "png", frames_only: bool = False, progressive=False):
    """Write a synthetic scene of T frames at H×W in a loader's on-disk
    layout: the Nvidia one (images/%03d.<fmt>, motion_masks/%03d.png,
    disp/%03d.npy, flow/%03d_{fwd,bwd}.npz) or, with layout="davis", the
    DAVIS one (5-digit names, epipolar_error_png/ masks, dpt/ disparity).
    Frames are the synthetic scene's with seeded texture, as PNG or (fmt
    "jpg") 4:2:0 JPEG at quality 90, baseline or with `progressive` (as
    `write_jpeg` takes it) progressive; masks gray PNG; flows carry a
    seeded consistency mask; poses_bounds.npy holds the poses. With
    frames_only, images/ alone (a raw video for the preprocessing commands).
    Returns the in-memory scene it was made from."""
    import os

    import numpy as np

    from .data import make_synthetic_scene
    from .data.imageio import write_png

    z, mask_dir, disp_dir = ((5, "epipolar_error_png", "dpt") if layout == "davis"
                             else (3, "motion_masks", "disp"))
    scene = make_synthetic_scene(T=T, H=H, W=W)
    rng = np.random.default_rng(seed)
    for sub in ("images",) if frames_only else ("images", mask_dir, disp_dir, "flow"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    rgbs = scene.rgbs.reshape(T, H, W, 3)
    fg = scene.fg_masks.reshape(T, H, W)
    disps = scene.disps.reshape(T, H, W)
    flows = {"fwd": scene.flows_f.reshape(T, H, W, 2), "bwd": scene.flows_b.reshape(T, H, W, 2)}
    for t in range(T):
        img = np.clip(rgbs[t] + rng.normal(0.0, 0.05, rgbs[t].shape), 0.0, 1.0)
        img = (img * 255).astype(np.uint8)
        name = os.path.join(root, "images", f"{t:0{z}d}.{fmt}")
        if fmt == "jpg":
            write_jpeg(name, img, quality=90, subsampling="420", progressive=progressive)
        else:
            write_png(name, img)
        if frames_only:
            continue
        write_png(os.path.join(root, mask_dir, f"{t:0{z}d}.png"), (fg[t] * 255).astype(np.uint8))
        np.save(os.path.join(root, disp_dir, f"{t:0{z}d}.npy"), disps[t])
        for kind, ok in (("fwd", t < T - 1), ("bwd", t > 0)):
            if ok:
                mask = (rng.random((H, W)) > 0.1).astype(np.float32)
                np.savez(os.path.join(root, "flow", f"{t:0{z}d}_{kind}.npz"),
                         flow=flows[kind][t], mask=mask)
    if frames_only:
        return scene
    # LLFF poses_bounds: [down, right, back, t | h w f] per frame + near/far
    c2w = scene.poses
    llff = np.concatenate([-c2w[..., 1:2], c2w[..., 0:1], c2w[..., 2:4]], -1)
    hwf = np.broadcast_to(np.array([H, W, scene.focal], np.float32)[None, :, None], (T, 3, 1))
    bounds = np.tile(np.array([[0.5, 5.0]], np.float32), (T, 1))
    np.save(os.path.join(root, "poses_bounds.npy"),
            np.concatenate([np.concatenate([llff, hwf], -1).reshape(T, 15), bounds], 1))
    return scene


@contextlib.contextmanager
def torch_threads(n: int):
    """Run the body with `n` intra-op CPU threads, restoring the count after.
    The TINY shapes gain nothing from more, and parallel test workers that
    each start one thread per core oversubscribe the machine."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# a baseline JPEG encoder for fixtures (test tooling: the CLI never writes
# JPEG). Annex K tables scaled by quality as libjpeg's jcparam.c does, a
# float forward DCT, the Annex K Huffman tables, vectorised bit packing.
# ---------------------------------------------------------------------------

_K1_LUMA = [16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
            14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
            18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
            49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99]
_K2_CHROMA = [17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
              24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32
# (BITS, HUFFVAL) of Annex K.3: DC luma, DC chroma, AC luma, AC chroma
_K3_DC_BITS = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0],
               [0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0])
_K3_AC_BITS = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D],
               [0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77])
_K3_AC_VALS = (bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a161718191a"
    "25262728292a3435363738393a434445464748494a535455565758595a636465666768696a737475767778"
    "797a838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7"
    "c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"), bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a162434e1"
    "25f11718191a262728292a35363738393a434445464748494a535455565758595a636465666768696a73"
    "7475767778797a82838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9"
    "bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"))
_SAMPLING = {"444": (1, 1), "422": (2, 1), "420": (2, 2), "440": (1, 2)}


def _jpeg_quant(base, quality: int):
    """jcparam.c jpeg_quality_scaling + jpeg_add_quant_table (baseline)."""
    import numpy as np

    q = max(1, min(100, int(quality)))
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return np.clip((np.asarray(base, np.int64) * scale + 50) // 100, 1, 255)


def _huff_table(bits, vals):
    """{symbol: (code, length)} of a DHT table, as arrays over 256 symbols."""
    import numpy as np

    code_of = np.zeros(256, np.int64)
    len_of = np.zeros(256, np.int64)
    code, k = 0, 0
    for l in range(1, 17):
        for _ in range(bits[l - 1]):
            code_of[vals[k]], len_of[vals[k]] = code, l
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


def _pack_bits(vals, lens) -> bytes:
    """Concatenate the codes vals[i] of lens[i] bits, pad the last byte with
    ones and stuff a zero after every 0xFF."""
    import numpy as np

    total = int(lens.sum())
    ev = np.repeat(np.arange(len(lens)), lens)
    start = np.cumsum(lens) - lens
    off = np.arange(total) - start[ev]
    bits = ((vals[ev] >> (lens[ev] - 1 - off)) & 1).astype(np.uint8)
    pad = (-total) % 8
    by = np.packbits(np.concatenate([bits, np.ones(pad, np.uint8)]))
    ff = np.flatnonzero(by == 0xFF)
    return np.insert(by, ff + 1, 0).tobytes()


def _scan_script(progressive, ncomp: int):
    """The scans of a progressive frame, each (components, Ss, Se, Ah, Al):
    True or "standard" is libjpeg's jcparam.c jpeg_simple_progression (10
    scans for YCbCr, 6 for gray); "spectral" spectral selection only (DC,
    then AC 1-5 and 6-63 per component); "dc_sa" DC successive
    approximation from Al = 2, then AC 1-63 per component."""
    comps = tuple(range(ncomp))
    if progressive in (True, "standard"):
        if ncomp == 3:
            return [(comps, 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1),
                    ((1,), 1, 63, 0, 1), ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
                    (comps, 0, 0, 1, 0), ((2,), 1, 63, 1, 0), ((1,), 1, 63, 1, 0),
                    ((0,), 1, 63, 1, 0)]
        return [(comps, 0, 0, 0, 1), (comps, 1, 5, 0, 2), (comps, 6, 63, 0, 2),
                (comps, 1, 63, 2, 1), (comps, 0, 0, 1, 0), (comps, 1, 63, 1, 0)]
    if progressive == "spectral":
        return [(comps, 0, 0, 0, 0)] + [s for c in comps for s in (((c,), 1, 5, 0, 0),
                                                                     ((c,), 6, 63, 0, 0))]
    if progressive == "dc_sa":
        return [(comps, 0, 0, 0, 2), (comps, 0, 0, 2, 1), (comps, 0, 0, 1, 0)] + [
            ((c,), 1, 63, 0, 0) for c in comps]
    raise ValueError(f"write_jpeg: unknown progressive script {progressive!r}")


class _ScanCoder:
    """jcphuff.c's encoder of one scan segment as a list of events: (table,
    symbol, extra bits, their count), table -1 for raw bits, in stream
    order. Keeps the end-of-band run and the buffered correction bits."""

    def __init__(self, al):
        self.al, self.ev, self.eobrun, self.be = al, [], 0, []

    def sym(self, tab, s, extra=0, n=0):
        self.ev.append((tab, s, extra, n))

    def raw(self, bits):
        self.ev.extend((-1, 0, b, 1) for b in bits)

    def emit_eobrun(self, tab):
        if self.eobrun:
            n = self.eobrun.bit_length() - 1
            self.sym(tab, n << 4, self.eobrun, n)
            self.eobrun = 0
            self.raw(self.be)
            self.be = []

    def ac_first(self, tab, band):
        """One block's band (natural values in zig-zag order Ss..Se)."""
        al, r = self.al, 0
        for v in band:
            t = (-v) >> al if v < 0 else v >> al
            if t == 0:
                r += 1
                continue
            self.emit_eobrun(tab)
            while r > 15:
                self.sym(tab, 0xF0)
                r -= 16
            n = t.bit_length()
            self.sym(tab, (r << 4) + n, t if v > 0 else ~t, n)
            r = 0
        if r:
            self.eobrun += 1
            if self.eobrun == 0x7FFF:
                self.emit_eobrun(tab)

    def ac_refine(self, tab, band):
        al = self.al
        absv = [abs(v) >> al for v in band]
        eob = max((k for k, t in enumerate(absv) if t == 1), default=-1)
        r, br = 0, []
        for k, t in enumerate(absv):
            if t == 0:
                r += 1
                continue
            while r > 15 and k <= eob:
                self.emit_eobrun(tab)
                self.sym(tab, 0xF0)
                r -= 16
                self.raw(br)
                br = []
            if t > 1:
                br.append(t & 1)
                continue
            self.emit_eobrun(tab)
            self.sym(tab, (r << 4) + 1, 0 if band[k] < 0 else 1, 1)
            self.raw(br)
            br, r = [], 0
        if r or br:
            self.eobrun += 1
            self.be += br
            if self.eobrun == 0x7FFF or len(self.be) > 1000 - 64 + 1:
                self.emit_eobrun(tab)


def _progressive_scans(blocks, samp, mx, my, planes_hw, restart_interval, script):
    """Encode the scans of `script` over the components' zig-zag blocks
    ([my, mx, v, h, 64] each, the MCU grid's): per scan its header fields,
    the Huffman tables it defines (a flat canonical code over the symbols
    it uses, one table per component class) and its entropy-coded data."""
    import numpy as np

    out = []
    for comps, ss, se, ah, al in script:
        if len(comps) > 1:  # interleaved: MCU order, each component's v × h blocks
            units = [[(ci, b) for ci in comps for b in
                      blocks[ci][y, x].reshape(-1, 64)] for y in range(my) for x in range(mx)]
        else:  # the component's own blocks, raster order over its sample size
            ci = comps[0]
            h, v = samp[ci]
            g = blocks[ci].transpose(0, 2, 1, 3, 4).reshape(my * v, mx * h, 64)
            ch, cw = planes_hw[ci]
            units = [[(ci, g[y, x])] for y in range(-(-ch // 8)) for x in range(-(-cw // 8))]
        per = restart_interval or len(units)
        segs = []
        for u0 in range(0, len(units), per):
            coder, pred = _ScanCoder(al), {}
            for unit in units[u0:u0 + per]:
                for ci, b in unit:
                    tab = min(ci, 1)
                    if ss == 0 and ah == 0:
                        dc = int(b[0]) >> al
                        d = dc - pred.get(ci, 0)
                        pred[ci] = dc
                        n = abs(d).bit_length()
                        coder.sym(tab, n, d if d >= 0 else d - 1, n)
                    elif ss == 0:
                        coder.raw([(int(b[0]) >> al) & 1])
                    elif ah == 0:
                        coder.ac_first(tab, b[ss:se + 1].tolist())
                    else:
                        coder.ac_refine(tab, b[ss:se + 1].tolist())
            coder.emit_eobrun(min(unit[0][0], 1))
            segs.append(coder.ev)
        # one table per class over the symbols this scan uses
        tables = {}
        for ev in segs:
            for tab, s, _, _ in ev:
                if tab >= 0:
                    tables.setdefault(tab, set()).add(s)
        codes = {}
        for tab, syms in tables.items():
            syms = sorted(syms)
            length = max(1, len(syms).bit_length())  # all-ones code left unused
            bits = [0] * 16
            bits[length - 1] = len(syms)
            codes[tab] = (bits, syms, {s: i for i, s in enumerate(syms)}, length)
        data = []
        for ev in segs:
            vals = np.array([(codes[t][2][s] << n) | (e & ((1 << n) - 1)) if t >= 0
                             else e for t, s, e, n in ev] or [0], np.int64)
            lens = np.array([codes[t][3] + n if t >= 0 else 1 for t, s, e, n in ev] or [0],
                            np.int64)
            data.append(_pack_bits(vals, lens))
        out.append(((comps, ss, se, ah, al), codes, data))
    return out


def write_jpeg(path: str, img, quality: int = 90, subsampling: str = "420",
               restart_interval: int = 0, progressive=False) -> None:
    """Write a uint8 image ([H, W] gray or [H, W, 3] RGB) as a JFIF JPEG:
    4:4:4, 4:2:2, 4:2:0 or 4:4:0 (h1v2) chroma for colour, the Annex K
    quantisation tables scaled by `quality`, restart markers every
    `restart_interval` MCUs (0: none). Baseline with the Annex K Huffman
    tables, or with `progressive` (True / "standard", "spectral" or
    "dc_sa", see `_scan_script`) a SOF2
    frame whose scans each define their own tables, as libjpeg's encoder
    must (jcmaster.c: the Annex K AC tables lack the end-of-band-run
    symbols). A fixture writer for the tests and the card's smoke run (the
    decoder's input): the forward DCT is float numpy, the baseline entropy
    coding vectorised, the progressive one a loop over blocks."""
    import struct

    import numpy as np

    img = np.asarray(img, np.uint8)
    gray = img.ndim == 2
    H, W = img.shape[:2]
    if gray:
        planes, samp = [img.astype(np.float32)], [(1, 1)]
    else:
        x = img.astype(np.float32)
        r, g, b = x[..., 0], x[..., 1], x[..., 2]
        y = 0.299 * r + 0.587 * g + 0.114 * b
        cb = -0.168735892 * r - 0.331264108 * g + 0.5 * b + 128
        cr = 0.5 * r - 0.418687589 * g - 0.081312411 * b + 128
        h, v = _SAMPLING[subsampling]
        planes, samp = [y, cb, cr], [(h, v), (1, 1), (1, 1)]
    hmax, vmax = samp[0]
    mx, my = -(-W // (8 * hmax)), -(-H // (8 * vmax))
    qts = [_jpeg_quant(_K1_LUMA, quality), _jpeg_quant(_K2_CHROMA, quality)]
    nat = np.array([0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40,
                    48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
                    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61,
                    54, 47, 55, 62, 63])
    u = np.arange(8)
    dct = (np.cos((2 * u[None, :] + 1) * u[:, None] * np.pi / 16) * np.where(
        u[:, None] == 0, np.sqrt(1 / 8), np.sqrt(2 / 8))).astype(np.float32)
    blocks = []  # per component: zig-zag coefficients [my, mx, v, h, 64]
    for ci, (p, (h, v)) in enumerate(zip(planes, samp)):
        fy, fx = vmax // v, hmax // h
        if fy > 1 or fx > 1:  # average fy×fx pixels (edge-replicated to even size)
            p = np.pad(p, ((0, (-p.shape[0]) % fy), (0, (-p.shape[1]) % fx)), mode="edge")
            p = p.reshape(p.shape[0] // fy, fy, p.shape[1] // fx, fx).mean((1, 3))
        p = np.pad(p, ((0, my * v * 8 - p.shape[0]), (0, mx * h * 8 - p.shape[1])), mode="edge")
        t = p.reshape(my * v, 8, mx * h, 8).transpose(0, 2, 1, 3) - 128.0
        coef = dct @ t @ dct.T  # orthonormal 2-D DCT-II
        q = qts[min(ci, 1)].reshape(8, 8).astype(np.float32)
        zz = np.rint(coef / q).astype(np.int64).reshape(my * v, mx * h, 64)[..., nat]
        blocks.append(zz.reshape(my, v, mx, h, 64).transpose(0, 2, 1, 3, 4))
    def seg(marker, body):
        return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body

    ncomp = len(planes)
    head = b"\xff\xd8" + seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    for t, q in enumerate(qts[:len(set(min(c, 1) for c in range(ncomp)))]):
        head += seg(0xDB, bytes([t]) + bytes(q[nat].astype(np.uint8)))
    sof = struct.pack(">BHHB", 8, H, W, ncomp) + b"".join(
        bytes([ci + 1, (h << 4) | v, min(ci, 1)]) for ci, (h, v) in enumerate(samp))
    if progressive:
        hw = [(-(-H * v // vmax), -(-W * h // hmax)) for h, v in samp]
        head += seg(0xC2, sof)
        if restart_interval:
            head += seg(0xDD, struct.pack(">H", restart_interval))
        for (comps, ss, se, ah, al), codes, data in _progressive_scans(
                blocks, samp, mx, my, hw, restart_interval, _scan_script(progressive, ncomp)):
            for tab, (bits, syms, _, _) in sorted(codes.items()):
                head += seg(0xC4, bytes([(0x00 if ss == 0 else 0x10) | tab]) + bytes(bits)
                            + bytes(syms))
            head += seg(0xDA, bytes([len(comps)]) + b"".join(
                bytes([ci + 1, (min(ci, 1) << 4) | min(ci, 1)]) for ci in comps)
                + bytes([ss, se, (ah << 4) | al]))
            head += b"".join((bytes([0xFF, 0xD0 + (i - 1) % 8]) if i else b"") + d
                             for i, d in enumerate(data))
        with open(path, "wb") as f:
            f.write(head + b"\xff\xd9")
        return
    # stream order: per MCU, per component, its v × h blocks
    order = [b.reshape(my * mx, -1, 64) for b in blocks]
    comp_of = np.concatenate([np.full(b.shape[1], ci) for ci, b in enumerate(order)])
    stream = np.concatenate(order, 1).reshape(-1, 64)  # [n MCU · blocks per MCU, 64]
    per_mcu = len(comp_of)
    n_mcu = my * mx
    tables = [(_huff_table(_K3_DC_BITS[t], list(range(12))),
               _huff_table(_K3_AC_BITS[t], list(_K3_AC_VALS[t]))) for t in (0, 1)]
    seg_len = restart_interval or n_mcu
    out = bytearray()
    for s_i, m0 in enumerate(range(0, n_mcu, seg_len)):
        blk = stream[m0 * per_mcu:min(m0 + seg_len, n_mcu) * per_mcu]
        comp = np.tile(comp_of, len(blk) // per_mcu)
        tab = np.minimum(comp, 1)
        # DC differences per component, the predictor reset per segment
        dc = blk[:, 0].copy()
        diff = np.empty_like(dc)
        for ci in range(len(planes)):
            sel = comp == ci
            d = dc[sel]
            diff[sel] = np.diff(d, prepend=0)
        # events: (block, position, sub-order) -> (code value, bit length)
        ev_key, ev_val, ev_len = [], [], []

        def emit(b, pos, sub, sym_code, sym_len, extra, nextra):
            ev_key.append(np.stack([b, pos, sub], 1))
            ev_val.append((sym_code << nextra) | (extra & ((1 << nextra) - 1)))
            ev_len.append(sym_len + nextra)

        nb = np.arange(len(blk))
        size = np.where(diff == 0, 0, np.floor(np.log2(np.maximum(np.abs(diff), 1))).astype(
            np.int64) + 1)
        extra = np.where(diff < 0, diff - 1, diff)
        dcode = np.where(tab == 0, tables[0][0][0][size], tables[1][0][0][size])
        dlen = np.where(tab == 0, tables[0][0][1][size], tables[1][0][1][size])
        emit(nb, np.zeros_like(nb), np.zeros_like(nb), dcode, dlen, extra, size)
        ac = blk[:, 1:]
        bi, ki = np.nonzero(ac)
        ki = ki + 1
        prev = np.zeros(len(ki), np.int64)  # the previous nonzero of the block (0: DC)
        same = np.flatnonzero(bi[1:] == bi[:-1]) + 1
        prev[same] = ki[same - 1]
        run = ki - prev - 1
        n_zrl = run // 16
        zb = np.repeat(bi, n_zrl)
        zk = np.repeat(ki, n_zrl)
        zj = np.arange(len(zb)) - np.repeat(np.cumsum(n_zrl) - n_zrl, n_zrl)
        zt = tab[zb]
        emit(zb, zk, zj, np.where(zt == 0, tables[0][1][0][0xF0], tables[1][1][0][0xF0]),
             np.where(zt == 0, tables[0][1][1][0xF0], tables[1][1][1][0xF0]),
             np.zeros_like(zb), np.zeros_like(zb))
        val = ac[bi, ki - 1]
        asize = np.floor(np.log2(np.abs(val))).astype(np.int64) + 1
        sym = ((run % 16) << 4) | asize
        at = tab[bi]
        emit(bi, ki, np.full(len(bi), 99), np.where(at == 0, tables[0][1][0][sym],
                                                    tables[1][1][0][sym]),
             np.where(at == 0, tables[0][1][1][sym], tables[1][1][1][sym]),
             np.where(val < 0, val - 1, val), asize)
        last = np.zeros(len(blk), np.int64)
        np.maximum.at(last, bi, ki)
        eb = np.flatnonzero(last < 63)
        et = tab[eb]
        emit(eb, np.full(len(eb), 64), np.zeros_like(eb),
             np.where(et == 0, tables[0][1][0][0], tables[1][1][0][0]),
             np.where(et == 0, tables[0][1][1][0], tables[1][1][1][0]),
             np.zeros_like(eb), np.zeros_like(eb))
        key = np.concatenate(ev_key)
        idx = np.lexsort((key[:, 2], key[:, 1], key[:, 0]))
        vals = np.concatenate(ev_val)[idx]
        lens = np.concatenate(ev_len)[idx]
        if s_i:
            out += bytes([0xFF, 0xD0 + (s_i - 1) % 8])
        out += _pack_bits(vals, lens)

    head += seg(0xC0, sof)
    for t in range(1 if gray else 2):
        head += seg(0xC4, bytes([0x00 | t]) + bytes(_K3_DC_BITS[t]) + bytes(range(12)))
        head += seg(0xC4, bytes([0x10 | t]) + bytes(_K3_AC_BITS[t]) + _K3_AC_VALS[t])
    if restart_interval:
        head += seg(0xDD, struct.pack(">H", restart_interval))
    sos = bytes([ncomp]) + b"".join(bytes([ci + 1, (min(ci, 1) << 4) | min(ci, 1)])
                                    for ci in range(ncomp)) + bytes([0, 63, 0])
    head += seg(0xDA, sos)
    with open(path, "wb") as f:
        f.write(head + bytes(out) + b"\xff\xd9")


def _entropy_ranges(data: bytes):
    """[(scan, [(start, end) of each entropy-coded segment])] of a JPEG
    file's bytes: the data after each SOS header, split at its restart
    markers, up to the marker that ends the scan."""
    out, pos = [], 0
    while True:
        i = data.find(b"\xff\xda", pos)
        if i < 0:
            return out
        a = i + 2 + int.from_bytes(data[i + 2:i + 4], "big")
        segs, s0, j = [], a, a
        while True:
            j = data.index(b"\xff", j)
            nxt = data[j + 1]
            if nxt in (0x00, 0xFF):
                j += 1
                continue
            if 0xD0 <= nxt <= 0xD7:
                segs.append((s0, j))
                s0 = j = j + 2
                continue
            segs.append((s0, j))
            break
        out.append((len(out), segs))
        pos = j


def damaged_jpegs(paths, out_dir: str, seed: int = 0):
    """Copies of JPEG files with damaged entropy-coded data that still parse
    (the markers, restart markers and scans intact), for holding the
    decoders' status words and the blocks they leave to the plain
    versions': per file, `flip` (a few bytes of one segment replaced),
    `cut` (the second half of one segment deleted: it ends early) and `ones`
    (a stretch of one segment replaced by stuffed 0xFF bytes: all-ones
    bits). Returns the paths written."""
    import os

    import numpy as np

    rng = np.random.default_rng(seed)
    written = []
    for p in paths:
        data = open(p, "rb").read()
        segs = [s for _, ss in _entropy_ranges(data) for s in ss if s[1] - s[0] >= 8]
        stem = os.path.splitext(os.path.basename(p))[0]
        for kind in ("flip", "cut", "ones"):
            a, b = segs[int(rng.integers(len(segs)))]
            d = bytearray(data)
            if kind == "flip":  # bytes away from any 0xFF, replaced by bytes below 0xFF
                ok = [i for i in range(a + 1, b - 1) if 0xFF not in d[i - 1:i + 2]]
                for i in rng.choice(ok, min(3, len(ok)), replace=False) if ok else []:
                    d[i] = int(rng.integers(0, 0xFF))
            elif kind == "cut":
                c = (a + b) // 2
                while c > a and d[c - 1] == 0xFF:
                    c -= 1
                del d[c:b]
            else:
                c = (a + b) // 2
                while c > a and d[c - 1] == 0xFF:
                    c -= 1
                n = min(8, (b - c) // 2)
                d[c:c + 2 * n] = b"\xff\x00" * n
            out = os.path.join(out_dir, f"{stem}_{kind}.jpg")
            with open(out, "wb") as f:
                f.write(bytes(d))
            written.append(out)
    return written


# sizes (H, W) that stress csrc/jpeg_idct.cu's tiles and edges, in every
# subsampling: DAVIS's 480p (chroma 427 wide), a frame narrower and shorter
# than one colour tile, widths 16k ± 1 at odd heights (one across the
# tile's 256 columns), and the box filter's 3×4 (chroma 2 samples wide)
EDGE_SIZES = ((480, 854), (12, 200), (17, 47), (33, 49), (9, 255), (21, 257), (3, 4))
EDGE_SUBSAMPLINGS = ("420", "422", "444", "440", "gray")


def edge_jpegs(out_dir: str, seed: int = 0, sizes=EDGE_SIZES):
    """write_jpeg files of every size in `sizes` in every subsampling of
    EDGE_SUBSAMPLINGS (smooth seeded content: gradients and noise), for
    holding the sample-reconstruction kernels to their plain versions at
    the frames' edges. Returns the paths written."""
    import os

    import numpy as np

    rng = np.random.default_rng(seed)
    paths = []
    for h, w in sizes:
        yy, xx = np.mgrid[:h, :w]
        for sub in EDGE_SUBSAMPLINGS:
            img = np.stack([xx * 255 // max(w - 1, 1), 128 + 60 * np.sin(yy / 7.0 + xx / 11.0),
                            (xx + 2 * yy) % 256], -1)
            img = np.clip(img + rng.normal(0, 10, (h, w, 3)), 0, 255).astype(np.uint8)
            paths.append(os.path.join(out_dir, f"edge_{h}x{w}_{sub}.jpg"))
            write_jpeg(paths[-1], img[..., 0] if sub == "gray" else img, 85,
                       "444" if sub == "gray" else sub)
    return paths


def extreme_idct_blocks(batch, seed: int = 0):
    """(coef int16 [n_blocks, 64], the batch with new quantisers) for holding
    the IDCT's 32-bit and 64-bit routes to the plain version: seeded blocks
    of full-range coefficients (±32767, -32768), of valid-range ones and of
    sparse ones, under quantisers from 1 to 255; and in each plane's first
    two blocks, column 0 (quantisers 2) at the 32-bit route's edge, its 8
    products ±35080 and ±35082 (2 · 17540, 2 · 17541) in the signs of islow
    pass 1's worst row: the first the largest such column under IDCT32_MAX
    (35081, odd: no int16 coefficient times 2 makes it), routed to 32 bits;
    the second just past it, whose 32-bit sum would wrap, routed to 64."""
    import dataclasses

    import numpy as np
    import torch

    from .data.jpeg import _islow_sums

    rng = np.random.default_rng(seed)
    n = batch.n_blocks
    kind = rng.integers(0, 3, n)[:, None]
    full = rng.integers(-32768, 32768, (n, 64))
    valid = rng.integers(-64, 65, (n, 64))
    sparse = np.where(rng.random((n, 64)) < 0.1, full, 0)
    coef = np.where(kind == 0, full, np.where(kind == 1, valid, sparse))
    quant = rng.integers(1, 256, (batch.plane.shape[0], 64))
    quant[:, 0::8] = 2
    a = _islow_sums(np.eye(8, dtype=np.int64))  # [input, output]
    sign = np.sign(a[:, np.argmax(np.abs(a).sum(0))])
    for p, b0 in enumerate(batch.plane_block0.tolist()[:-1]):
        for i, m in enumerate((17540, 17541)):
            if b0 + i < batch.plane_block0[p + 1]:
                coef[b0 + i, 0::8] = sign * m
    return (torch.from_numpy(coef.astype(np.int16)),
            dataclasses.replace(batch, quant=torch.from_numpy(quant.astype(np.int32))))
