"""Traffic kind ``serve_bulk``: one client in a closed loop, in process,
asking ``GeneratorService.sample(n, labels=..., seed=...)`` for requests
of ``request_images`` images (the workload's), each with its own seed and,
for CGAN, a permutation of the classes drawn from that seed, cycled over
its rows. Set-up renders one request of that shape (its renders capture
the batch's graph). The window sends the next request when the last has
returned, until ``--seconds`` have passed.

``serve_img_s`` is every image of the requests completed in the window,
delivered as uint8 numpy on the host, over the window's time. The check:
``check_requests`` of the first ``check_span`` requests, drawn from the
seed, against the reference's renders (``judge.image_numbers``).
"""

from __future__ import annotations

import math
import time

from portbench import core, judge, serving, weights
from portbench.reference import cost, gan

REPLAYED_STEPS = False  # no steps: the control is read in every render


def readings(ctx, precision: str = "f32", fault: str = "") -> dict:
    """The judge's numbers for the reference at ``precision`` put in the
    program's place (the control: ``"fp8"``) on this run's checked
    requests at the cell's size."""
    cfg, wl = ctx.config, ctx.workload
    g = weights.make(cfg, ctx.seed_for("weights"), ctx.device)["g"]
    got, want = [], []
    for i in sorted(serving.checked_requests(ctx.seed, wl["check_span"], wl["check_requests"])):
        seed = serving.request_seed(ctx.seed, i)
        labels = (serving.request_labels(ctx.seed, i, cfg["num_classes"])
                  if cfg["conditional"] else None)
        n = wl["request_images"]
        got.append(serving.reference_images(g, cfg, seed, n, ctx.device, labels, precision))
        want.append(serving.reference_images(g, cfg, seed, n, ctx.device, labels))
    return judge.image_numbers(got, want)


def run(ctx) -> core.Outcome:
    cfg, wl = ctx.config, ctx.workload
    t = time.perf_counter()
    svc, path = serving.service(ctx)
    ctx.setup_parts["service_s"] = time.perf_counter() - t
    n, classes = wl["request_images"], cfg["num_classes"]
    shape = (n, cfg["image_size"], cfg["image_size"], cfg["channels"])
    checked = serving.checked_requests(ctx.seed, wl["check_span"], wl["check_requests"])

    def request(i: int):
        seed = serving.request_seed(ctx.seed, i)
        labels = serving.request_labels(ctx.seed, i, classes) if cfg["conditional"] else None
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

    g = serving.reference_generator(path, ctx.device)
    order = sorted(kept)
    ref = [serving.reference_images(g, cfg, kept[i][0], n, ctx.device, kept[i][1]) for i in order]
    nums = (judge.image_numbers([kept[i][2] for i in order], ref) if order else
            {"worst_image_lsb": math.inf, "mean_lsb": math.inf})
    return core.Outcome(
        e2e={"serve_img_s": images / elapsed}, attempted=done, failed=bad,
        checks=core.limited(ctx, nums), numbers=nums, memory_peak=peak,
        answered=bad == 0 and len(kept) == len(checked & set(range(done))),
        counts={"rendered_images": done * -(-n // bs) * bs},
        facts={"flops_per_image": cost.forward_flops(cfg, bs) / bs,
               "bn_act_bytes_per_render": cost.bn_act_bytes(
                   cfg, bs, serving.DTYPES[cfg["compute_dtype"]].itemsize),
               "bn_act_layers": len(gan.stage_widths(cfg))},
        notes=[f"requests {done}, checked {order}"])
