"""What the serving kinds share: the service built from the seed's weights
through the program's loader, each request's seed and labels drawn from
the run's seed, and the reference's renders of the requests whose images
are checked.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from portbench import core, weights
from portbench.reference import frozen, gan

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def kernel_build(device) -> dict:
    """The program's BN kernel library made ready, timed: built by ``nvcc``
    (inside the checkout) on a checkout's first run, else loaded. → the
    set-up's parts {"kernel_build_s", "kernel_built"} (none off the card)."""
    if device.type != "cuda":
        return {}
    import time

    from jckx_torch.kernels import _build

    built = not os.path.exists(_build.library_path("fused_bn_act"))
    t = time.perf_counter()
    _build.load("fused_bn_act")
    return {"kernel_build_s": time.perf_counter() - t, "kernel_built": int(built)}


def service(ctx):
    """The program's ``GeneratorService`` over a reference ``.pt`` of the
    seed's weights (written to the run's temporary directory, read by the
    program's ``load_generator``). → (service, the file)."""
    from jckx_torch.serve import GeneratorService

    cfg = ctx.config
    ctx.setup_parts.update(kernel_build(ctx.device))
    path = os.path.join(ctx.tmp, "weights.pt")
    weights.write_reference_checkpoint(path, weights.make(cfg, ctx.seed_for("weights"),
                                                          ctx.device))
    svc = GeneratorService(path, batch_size=cfg["serve"]["batch_size"],
                           compute_dtype=DTYPES[cfg["compute_dtype"]], device=ctx.device)
    counts = sum(p.numel() for p in svc.G.parameters())
    if counts != cfg["params"]["g"]:
        raise SystemExit(f"portbench: G holds {counts} parameters, the configuration "
                         f"{cfg['params']['g']}")
    return svc, path


def request_seed(seed: int, i: int) -> int:
    """Request ``i``'s own seed, from the run's."""
    return core.sub_seed(seed, f"request:{i}") % 2 ** 62


def request_labels(seed: int, i: int, classes: int) -> List[int]:
    """Request ``i``'s labels: a permutation of the classes, cycled over its rows."""
    return np.random.default_rng(request_seed(seed, i)).permutation(classes).tolist()


def reference_generator(path: str, device) -> dict:
    """G's weights as the reference reads them from the ``.pt`` file."""
    sd = torch.load(path, map_location="cpu", weights_only=True)["model_g"]
    return {k: v.float().to(device) for k, v in sd.items()
            if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))}


def reference_images(g: dict, cfg: dict, seed: int, n: int, device,
                     labels: Optional[List[int]] = None, precision: str = "f32") -> np.ndarray:
    """The reference's uint8 images of a request (its own ``seed``, ``n``
    images, CGAN ``labels`` cycled over its rows), batch by batch."""
    gan.no_tf32()
    out = []
    with torch.no_grad():
        for z, ids, take in frozen.request_latents(seed, n, cfg["serve"]["batch_size"],
                                                   cfg["z_dim"], device, labels):
            onehot = None if ids is None else torch.nn.functional.one_hot(
                ids, cfg["num_classes"]).float()
            out.append(frozen.to_u8(gan.generator(g, cfg, z, onehot, precision))[:take].cpu())
    return torch.cat(out).numpy()


def checked_requests(seed: int, span: int, count: int) -> set:
    """The request indices whose images are compared: ``count`` of the
    first ``span``, drawn from the seed."""
    rng = np.random.default_rng(core.sub_seed(seed, "checked"))
    return set(rng.choice(span, size=min(count, span), replace=False).tolist())


def release() -> None:
    """Give the freed program's device memory back (after ``del``)."""
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
