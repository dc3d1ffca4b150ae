"""Traffic kind ``serve_bulk_biggan``: ``serve_bulk``'s closed loop for
BigGAN's class-conditional generator. One client, in process, asks
``GeneratorService.sample(n, labels=..., seed=...)`` for requests of
``request_images`` images (the workload's), each with its own seed and a
permutation of the classes drawn from that seed, cycled over its rows
(``serving.request_labels``: a batch of fewer rows than classes holds no
class twice), z ~ N(0, I). Set-up writes the seed's weights
(``reference/biggan.make_weights``: every parameter drawn, each σ exact)
as a checkpoint, which the program's ``load_generator`` reads, asserts G's
parameter count against the configuration's, and renders one request of
the window's shape (its renders capture the batch's graph). The window
sends the next request when the last has returned, until ``--seconds``
have passed.

``serve_img_s`` is every image of the requests completed in the window,
delivered as uint8 numpy on the host, over the window's time. The check:
``check_requests`` of the first ``check_span`` requests, drawn from the
seed, against the plain reference's f32 renders of the same z and labels,
batch by batch (``judge.image_numbers``). A workload's own
``compute_dtype``, where it states one, runs the program in it in place of
the configuration's (the CPU cut's runs float32).

The readers' facts: one image's forward operations and G's BN bytes
(``reference/biggan``: ``forward_flops``, ``bn_bytes``), the output BN's
alone for ``bn_act_roofline`` (the one layer on the per-channel kernel:
``bn_layer_bytes``' last), the attention product's operations and bytes
at its published widths.
"""

from __future__ import annotations

import math
import os
import time

import torch

from portbench import core, judge, serving
from portbench.reference import biggan, frozen
from portbench.traffic.finetune import compute_dtype

REPLAYED_STEPS = False  # no steps: the control is read in every render


def reference_images(g: dict, cfg: dict, seed: int, n: int, device, labels,
                     precision: str = "f32", fault: str = ""):
    """The reference's uint8 images of a request (its own ``seed``, ``n``
    images, ``labels`` cycled over its rows), batch by batch."""
    out = []
    with torch.no_grad():
        for z, ids, take in frozen.request_latents(seed, n, cfg["serve"]["batch_size"],
                                                   cfg["z_dim"], device, labels):
            onehot = torch.nn.functional.one_hot(ids, cfg["num_classes"]).float()
            imgs = biggan.generator(g, cfg, z, onehot, precision, fault)
            out.append(frozen.to_u8(imgs)[:take].cpu())
    return torch.cat(out).numpy()


def _checked(ctx):
    """(index, seed, labels) of each checked request."""
    cfg, wl = ctx.config, ctx.workload
    for i in sorted(serving.checked_requests(ctx.seed, wl["check_span"], wl["check_requests"])):
        yield i, serving.request_seed(ctx.seed, i), serving.request_labels(ctx.seed, i,
                                                                          cfg["num_classes"])


def readings(ctx, precision: str = "f32", fault: str = "") -> dict:
    """The judge's numbers for the reference at ``precision`` with ``fault``
    (``"nocond"``, ``"noattn"``) put in the program's place (the control:
    ``"fp8"``) on this run's checked requests at the cell's size."""
    cfg, n = ctx.config, ctx.workload["request_images"]
    g = biggan.make_weights(cfg, ctx.seed_for("weights"), ctx.device)
    got, want = [], []
    for _, seed, labels in _checked(ctx):
        got.append(reference_images(g, cfg, seed, n, ctx.device, labels, precision, fault))
        want.append(reference_images(g, cfg, seed, n, ctx.device, labels))
    return judge.image_numbers(got, want)


def _service(ctx):
    """The program's ``GeneratorService`` over a checkpoint of the seed's
    weights. → (service, the file). A program without BigGAN's generator
    is refused at once, before the weights are made."""
    try:
        from jckx_torch.models import biggan as _  # noqa: F401
    except ImportError:
        raise SystemExit("portbench: jckx_torch has no BigGAN generator "
                         "(jckx_torch.models.biggan), the model this cell serves") from None
    from jckx_torch.serve import GeneratorService

    cfg = ctx.config
    ctx.setup_parts.update(serving.kernel_build(ctx.device))
    t = time.perf_counter()
    path = os.path.join(ctx.tmp, "biggan.pt")
    biggan.write_checkpoint(path, biggan.make_weights(cfg, ctx.seed_for("weights"), ctx.device))
    ctx.setup_parts["weights_s"] = time.perf_counter() - t
    svc = GeneratorService(path, batch_size=cfg["serve"]["batch_size"],
                           compute_dtype=serving.DTYPES[compute_dtype(ctx)], device=ctx.device)
    counts = sum(p.numel() for p in svc.G.parameters())
    if counts != cfg["params"]["g"]:
        raise SystemExit(f"portbench: G holds {counts} parameters, the configuration "
                         f"{cfg['params']['g']}")
    return svc, path


def run(ctx) -> core.Outcome:
    cfg, wl = ctx.config, ctx.workload
    t = time.perf_counter()
    svc, path = _service(ctx)
    ctx.setup_parts["service_s"] = time.perf_counter() - t
    n, classes = wl["request_images"], cfg["num_classes"]
    shape = (n, cfg["image_size"], cfg["image_size"], cfg["channels"])
    checked = serving.checked_requests(ctx.seed, wl["check_span"], wl["check_requests"])

    def request(i: int):
        seed = serving.request_seed(ctx.seed, i)
        labels = serving.request_labels(ctx.seed, i, classes)
        return seed, labels, svc.sample(n, labels=labels, seed=seed)

    t = time.perf_counter()
    request(-1)  # warm: the batch's graph, the request's drains
    ctx.setup_parts["warm_s"] = time.perf_counter() - t
    kept, done, bad, images = {}, 0, 0, 0
    ctx.setup_done()
    t0 = time.perf_counter()
    with ctx.window():
        while time.perf_counter() - t0 < ctx.seconds:
            with ctx.span("request"):
                seed, labels, imgs = request(done)
            if imgs.shape != shape or imgs.dtype.name != "uint8":
                bad += 1
            else:
                images += n
            if done in checked:
                kept[done] = (seed, labels, imgs)
            done += 1
    elapsed = time.perf_counter() - t0
    peak = ctx.memory_peak()
    bs = svc.batch_size
    del svc
    serving.release()

    g = biggan.read_checkpoint(path, ctx.device)
    order = sorted(kept)
    ref = [reference_images(g, cfg, kept[i][0], n, ctx.device, kept[i][1]) for i in order]
    nums = (judge.image_numbers([kept[i][2] for i in order], ref) if order else
            {"worst_image_lsb": math.inf, "mean_lsb": math.inf})
    element = serving.DTYPES[compute_dtype(ctx)].itemsize
    layer_bytes = biggan.bn_layer_bytes(cfg, bs, element)
    return core.Outcome(
        e2e={"serve_img_s": images / elapsed}, attempted=done, failed=bad,
        checks=core.limited(ctx, nums), numbers=nums, memory_peak=peak,
        answered=bad == 0 and len(kept) == len(checked & set(range(done))),
        counts={"rendered_images": done * -(-n // bs) * bs},
        facts={"flops_per_image": biggan.forward_flops(cfg, 1),
               "bn_bytes_per_image": sum(layer_bytes) / bs,
               "bn_act_bytes_per_render": layer_bytes[-1], "bn_act_layers": 1,
               "attn_flops_per_image": biggan.attention_flops(cfg),
               "attn_bytes_per_image": biggan.attention_bytes(cfg, element)},
        notes=[f"requests {done}, checked {order}"])
