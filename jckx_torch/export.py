"""Sealed generator artifacts: a ``torch.export`` program — port of
``jckx/export.py``.

jckx ships its sampler as one StableHLO blob (``jax.export``); the port
ships it as one ``torch.export`` program, saved with ``torch.export.save``
as ``<dst>`` (``.pt2``), that any process with torch and this package can
run:

    from jckx_torch.export import load_exported
    sample = load_exported("gen.pt2")          # on the card; device="cpu" too
    imgs = sample(seed=0)                      # (bs, S, S, C) uint8

with no model code and no checkpoint parsing. The program is the service's
sampler (``GeneratorService``: float, or ``--quant int8`` with the W8A8
params calibrated at export; the weights are part of the program), fed
with z drawn inside it from the int32 seed exactly as jckx's artifact
draws it, ``jax.random.normal(PRNGKey(seed), (bs, z_dim))`` (``rng.py``;
``jckx/export.py:92-103``), and converted by ``tanh_to_u8``. A CGAN
program takes one int32 label per image, one-hot inside the program as
``jax.nn.one_hot`` does (a label outside [0, K) gives a zero row).

The program runs BN + activation through the hand-written kernel, as the
service does: ``bn_act`` calls the registered operator
``jckx_torch::normalize_act`` (``kernels/fused_bn_act.py``), which the
trace records as one node (by its fake, shape-only implementation) and
which launches the kernel when the program runs on the card (its plain
version on the CPU). So the program holds no code of the kernel: loading
it needs this package imported, which registers the operator
(``load_exported`` and ``ArtifactService`` do). jckx's artifact takes the
plain XLA lowering instead (``jckx/export.py:20-24``); the two routes
agree within one bf16 rounding (``tests/test_torch_gpu.py``).

A ``.json`` sidecar beside the program carries jckx's keys (``:113-128``);
``platforms`` names the device the program was exported on. jckx's
``--platforms`` is a comma list of lowering targets (``:265-266``); a
``.pt2`` holds one device's program, so the list must name the platform of
``--device`` (``cuda`` or ``cpu``), and entries the port cannot lower for
(``tpu`` in jckx's default ``cpu,tpu``) are named in a warning and skipped.
``load_exported`` and ``ArtifactService`` move the program to the device
they run on (``torch.export.passes.move_to_device_pass``).
``ArtifactService`` is the serving end: the surface the HTTP daemon reads
(``step``, ``conditional``, ``num_classes``, ``geo``, ``batch_size``,
``sample``), backed by the program and its sidecar alone, with jckx's
seeding (``:218-255``).

CLI:
    python -m jckx_torch export --ckpt save/dcgan/<ts>/latest.ckpt --dst gen.pt2
    python -m jckx_torch export --ckpt ref.pt --dst gen.pt2 --batch_size 64 --quant int8
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

import numpy as np
import torch

from jckx_torch import rng
from jckx_torch.models.dcgan import GANGeometry
from jckx_torch.serve import (GeneratorService, pipelined_sample, tanh_to_u8,
                              validate_sample_args)
from jckx_torch.utils.device import resolve_device

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
LOWERABLE = ("cuda", "cpu")  # the --platforms entries a .pt2 can be exported for


class _Sampler(torch.nn.Module):
    """The exported program: seed (and labels) → uint8 images, through a
    service's sampler on its parameters."""

    def __init__(self, svc):
        super().__init__()
        self._apply = svc.sampler_apply
        self.bs, self.z_dim, self.num_classes = svc.batch_size, svc.geo.z_dim, svc.num_classes
        self.quant = svc.quant
        if svc.quant is None:
            self.g = svc.params
        else:  # the int8 params as buffers, so that they are saved with the program;
            # each its own storage (some are views of G's or of one scale vector)
            self.q = torch.nn.Module()
            for k, v in svc.params.items():
                self.q.register_buffer(k, v.clone())

    def _params(self):
        return self.g if self.quant is None else dict(self.q.named_buffers())

    def forward(self, seed: torch.Tensor, labels: Optional[torch.Tensor] = None) -> torch.Tensor:
        z = rng.normal_from_seed(seed, (self.bs, self.z_dim))
        onehot = None
        if labels is not None:
            classes = torch.arange(self.num_classes, device=labels.device)
            onehot = (labels.to(torch.int64)[:, None] == classes).float()
        return tanh_to_u8(self._apply(self._params(), z, onehot))


def export_generator(ckpt_path: str, dst: str, batch_size: int = 64,
                     conditional: Optional[bool] = None, num_classes: Optional[int] = None,
                     use_ema: Optional[bool] = None, geo_overrides: Optional[dict] = None,
                     compute_dtype=torch.bfloat16, quant: Optional[str] = None,
                     device=None) -> dict:
    """Export the checkpoint's sampler to ``dst`` (+ ``dst.json``) on
    ``device`` (default the card). → the info dict (what the CLI prints)."""
    if batch_size < 1:
        raise ValueError(f"export batch_size {batch_size} must be >= 1 (a zero-batch artifact "
                         f"would serve nothing, forever)")
    svc = GeneratorService(ckpt_path, conditional=conditional, num_classes=num_classes,
                           batch_size=batch_size, compute_dtype=compute_dtype, use_ema=use_ema,
                           geo_overrides=geo_overrides, quant=quant, device=device)
    dev, geo = svc.device, svc.geo
    args = (torch.zeros((), dtype=torch.int32, device=dev),)
    if svc.conditional:
        args += (torch.zeros((batch_size,), dtype=torch.int32, device=dev),)
    with torch.no_grad():
        program = torch.export.export(_Sampler(svc).eval(), args, strict=False)
    os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
    torch.export.save(program, dst)
    info = {
        "wrote": dst, "bytes": os.path.getsize(dst), "step": svc.step,
        "ema_weights": svc.used_ema,  # which generator was actually baked in
        "batch_size": batch_size, "conditional": svc.conditional,
        "num_classes": svc.num_classes if svc.conditional else None,
        "z_dim": geo.z_dim, "image_size": geo.image_size,
        "channels": geo.channels, "base_width": geo.base_width,
        "compute_dtype": str(compute_dtype).replace("torch.", ""), "platforms": [dev.type],
        "quant": svc.quant,
        "inputs": (["seed:i32[]", f"labels:i32[{batch_size}]"] if svc.conditional
                   else ["seed:i32[]"]),
        "output": f"u8[{batch_size},{geo.image_size},{geo.image_size},{geo.channels}]",
    }
    with open(dst + ".json", "w") as f:
        json.dump(info, f, indent=1)
    return info


def read_sidecar(path: str) -> dict:
    """The ``.json`` beside an artifact (``.pt2``, or jckx's ``.jaxexp``)."""
    try:
        with open(path + ".json") as f:
            return json.load(f)
    except (OSError, ValueError) as e:
        raise ValueError(f"{path}: missing/unreadable .json sidecar (written by the exporter "
                         f"next to the program): {e}") from e


def _load_program(path: str, device: torch.device):
    """→ (the program as a callable module on ``device``, its input count)."""
    from torch.export.passes import move_to_device_pass

    program = move_to_device_pass(torch.export.load(path), str(device))
    return program.module(), len(program.graph_signature.user_inputs)


def load_exported(path: str, device=None):
    """→ ``sample(seed[, labels]) -> uint8 images`` on ``device`` (default
    the card) from an exported program. Inputs are converted to the int32
    shapes the program takes."""
    dev = resolve_device(device)
    call, n_in = _load_program(path, dev)

    def sample(seed: int, labels=None) -> torch.Tensor:
        args = [torch.as_tensor(seed, dtype=torch.int32, device=dev)]
        if n_in == 2:
            if labels is None:
                raise ValueError("this artifact was exported from a conditional (CGAN) "
                                 "checkpoint — pass labels (one int per image)")
            args.append(torch.as_tensor(np.asarray(labels), dtype=torch.int32, device=dev))
        elif labels is not None:
            raise ValueError("this artifact was exported from an unconditional (DCGAN) "
                             "checkpoint — it takes no labels")
        with torch.inference_mode():
            return call(*args)

    return sample


class ArtifactService:
    """Serve from an exported artifact: the surface the HTTP daemon reads
    from ``GeneratorService``, backed by the ``.pt2`` and its sidecar only.

    Seeding (``jckx/export.py:226-237``): request k of a service seeded
    with s starts at base = s·1_000_003 + k·65_537 (or base = the request's
    ``seed``), and its batch i renders the program's seed
    (base + i) mod (2³¹ − 1). A CGAN request without labels draws each
    batch's classes on the host from ``np.random.default_rng([base mod 2⁶³,
    i])`` (``:243-251``): the program's label input is fixed, and the
    same seed gives the same bytes."""

    def __init__(self, artifact_path: str, seed: int = 0, device=None):
        side = read_sidecar(artifact_path)
        self.device = resolve_device(device)
        self._call, n_in = _load_program(artifact_path, self.device)
        self.conditional = n_in == 2
        self.batch_size = int(side["batch_size"])
        if self.batch_size < 1:
            raise ValueError(f"{artifact_path}: sidecar batch_size {self.batch_size} must be >= 1")
        if self.conditional:
            try:
                self.num_classes = int(side["num_classes"])
            except (KeyError, TypeError) as e:
                raise ValueError(f"{artifact_path}: conditional artifact but the sidecar has no "
                                 f"usable num_classes") from e
        else:
            self.num_classes = 0  # no label surface
        self.step = side.get("step", 0)
        self.geo = GANGeometry(z_dim=side["z_dim"], image_size=side["image_size"],
                               channels=side["channels"], base_width=side["base_width"])
        self._base_seed = seed
        self._count = 0

    def batch_labels(self, base: int, batch_i: int) -> np.ndarray:
        """The host-side random classes of batch ``batch_i`` of a request
        that starts at ``base``."""
        gen = np.random.default_rng([base % (2**63), batch_i])
        return gen.integers(0, self.num_classes, size=self.batch_size, dtype=np.int32)

    def sample(self, n: int, labels=None, seed: Optional[int] = None) -> np.ndarray:
        """→ uint8 images (n, S, S, C); ``seed`` makes the request
        deterministic, ``labels`` (CGAN) cycle over its rows."""
        labels = validate_sample_args(n, labels, self.conditional)
        if labels is not None:
            labels = np.asarray(labels, np.int64)
            if labels.min() < 0 or labels.max() >= self.num_classes:
                raise ValueError(f"labels must lie in [0, {self.num_classes})")
        if seed is None:
            self._count += 1
            base = self._base_seed * 1_000_003 + self._count * 65_537
        else:
            base = seed
        bs = self.batch_size

        def render(made: int):
            batch_i = made // bs
            args = [torch.tensor((base + batch_i) % (2**31 - 1), dtype=torch.int32,
                                 device=self.device)]
            if self.conditional:
                if labels is not None:
                    lab = labels[(made + np.arange(bs)) % len(labels)].astype(np.int32)
                else:
                    lab = self.batch_labels(base, batch_i)
                args.append(torch.from_numpy(lab).to(self.device))
            with torch.inference_mode():
                return self._call(*args)

        return pipelined_sample(n, bs, render)


def get_args(argv=None):
    p = argparse.ArgumentParser(description="jckx_torch sealed generator export (torch.export)")
    p.add_argument("--ckpt", required=True,
                   help="the port's latest.ckpt or .pt, a reference torch .pt or a jckx .ckpt")
    p.add_argument("--dst", required=True, help="output artifact path (.pt2)")
    p.add_argument("-b", "--batch_size", type=int, default=64,
                   help="the exported program's batch")
    p.add_argument("--compute_dtype", default="bfloat16", choices=sorted(_DTYPES))
    p.add_argument("--weights", default="auto", choices=["auto", "live", "ema"],
                   help="which generator to bake in: 'auto' the EMA when the file has one; "
                        "the info line's ema_weights says what shipped")
    p.add_argument("--quant", default="", choices=["", "int8"],
                   help="int8 = bake in the W8A8 sampler (calibrated here, from seed 0)")
    p.add_argument("--conditional", action="store_true", default=None)
    p.add_argument("--num_classes", type=int, default=None)
    # explicit geometry, checked against the weights (as serve takes them)
    for name in ("z_dim", "image_size", "channels", "base_width"):
        p.add_argument(f"--{name}", type=int, default=None)
    p.add_argument("--device", default=None,
                   help="the device the program is exported on and for (default cuda)")
    p.add_argument("--platforms", default=None,
                   help="jckx's comma list of lowering targets: it must name --device's "
                        "platform (cuda / cpu); others (tpu) are skipped with a warning")
    return p.parse_args(argv)


def check_platforms(platforms: Optional[str], device) -> None:
    """``--platforms`` against the device the program is exported on:
    raises ``SystemExit`` when the list lacks its platform, warns about
    (and skips) the entries the port cannot lower for."""
    if platforms is None:
        return
    wanted = [s for s in platforms.split(",") if s]
    skipped = [s for s in wanted if s not in LOWERABLE]
    if skipped:
        print(f"warning: --platforms {','.join(skipped)}: the port exports a torch.export "
              f"program for cuda or cpu only; skipped", file=sys.stderr)
    platform = torch.device("cuda" if device is None else device).type
    if platform not in wanted:
        raise SystemExit(f"jckx_torch export: --platforms {platforms!r} does not name "
                         f"{platform!r}, the platform of --device; a .pt2 holds that device's "
                         f"program only")


def main(argv=None) -> int:
    a = get_args(argv)
    check_platforms(a.platforms, a.device)
    overrides = {k: getattr(a, k) for k in ("z_dim", "image_size", "channels", "base_width")
                 if getattr(a, k) is not None}
    info = export_generator(
        a.ckpt, a.dst, batch_size=a.batch_size, conditional=a.conditional,
        num_classes=a.num_classes, use_ema={"auto": None, "live": False, "ema": True}[a.weights],
        geo_overrides=overrides or None, compute_dtype=_DTYPES[a.compute_dtype],
        quant=a.quant or None, device=a.device)
    print(json.dumps(info))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
