"""NUTS on the pullback of the trained flagship (NeuTra-NUTS), with and
without Stan's diagonal mass adaptation.

    python -m normflows_tpu_torch.examples.neutra_nuts [--iters 2000] [--seeds 3]

The flagship of ``nsf_cylinder`` (12 circular AR RQ-spline layers, hidden
512, 10 bins) trained on GaussianVonMises by ``--iters`` chunked bf16
reverse-KL steps (2^14 samples, Adam 5e-4 with cosine decay, 100 steps a
chunk), then sampled in float32: NUTS on its ``PullbackTarget`` (256
chains, max_depth 8, 12 + 8 warm-up transitions, 8 sampling steps) at each
seed, with ``adapt_mass`` on and off.  One JSON line a run: the tuned step,
the adapted inverse mass, the mean depth, the leaf steps, the divergence
rate, the spread of the latent draws' coordinates, the moments of the
pushed-forward draws against the cylinder law (mean x0, std x0 and
E cos(phi - 3 x0) = I1(1)/I0(1) = 0.44639) and the seconds.  ``--device
cpu --iters 4 --chunk 2 --num-samples 256 --hidden 16 --chains 16
--max-depth 4 --adapt 4 --steps 2 --seeds 1`` checks the wiring (~20 s).
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from .. import training
from ..sampling import NUTS, PullbackTarget
from ..utils import set_compute_dtype
from .nsf_cylinder import build_model

GVM_COS = 0.44639


def train(args, device):
    model = set_compute_dtype(build_model(device, hidden=args.hidden), "bfloat16")
    opt = torch.optim.Adam(model.parameters(), lr=5e-4, capturable=device.type == "cuda")

    def loss_fn(model, batch, generator):
        return model.reverse_kld(args.num_samples, generator=generator)

    state, chunk = training.make_step_chunk(
        model, opt, loss_fn, args.chunk,
        schedule=training.cosine_decay_schedule(5e-4, args.iters))
    gen = torch.Generator(device=device).manual_seed(0)
    for _ in range(args.iters // args.chunk):
        state, metrics = chunk(state, gen)
    return set_compute_dtype(model, "float32"), float(metrics["loss"][-1])


def run(model, args, device, seed, adapt_mass):
    nuts = NUTS.create(PullbackTarget(model), 2, step_size=0.2, max_depth=args.max_depth,
                       device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    us, info = nuts.sample(args.chains, args.steps, num_adapt=args.adapt,
                           adapt_mass=adapt_mass, generator=gen)
    with torch.no_grad():
        x = model.forward(us.reshape(-1, 2)).double()
    cos = torch.cos(x[:, 1] - 3.0 * x[:, 0])
    u = us.reshape(-1, 2).double()
    return {"seed": seed, "adapt_mass": adapt_mass,
            "seconds": time.perf_counter() - t0,
            "step_size": float(info["step_size"]), "inv_mass": info["inv_mass"].tolist(),
            "mean_depth": float(info["mean_depth"]),
            "divergence_rate": float(info["divergence_rate"]),
            "leaves_total": info["leaves_total"], "transitions": info["transitions"],
            "latent_std": u.std(0).tolist(),
            "latent_abs_max": u.abs().amax(0).tolist(),
            "mean_x0": float(x[:, 0].mean()), "std_x0": float(x[:, 0].std()),
            "mean_cos": float(cos.mean()), "cos_gap": float(cos.mean()) - GVM_COS,
            "chains": args.chains, "max_depth": args.max_depth, "num_adapt": args.adapt,
            "steps": args.steps}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--chunk", type=int, default=100)
    ap.add_argument("--num-samples", type=int, default=2**14)
    ap.add_argument("--hidden", type=int, default=512)
    ap.add_argument("--chains", type=int, default=256)
    ap.add_argument("--max-depth", type=int, default=8)
    ap.add_argument("--adapt", type=int, default=20, help="warm-up transitions")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    t0 = time.perf_counter()
    model, loss = train(args, device)
    print(json.dumps({"trained": args.iters, "final_loss": loss,
                      "seconds": time.perf_counter() - t0}), flush=True)
    records = []
    for seed in range(args.seeds):
        for adapt_mass in (True, False):
            records.append(run(model, args, device, seed, adapt_mass))
            print(json.dumps(records[-1]), flush=True)
    return records


if __name__ == "__main__":
    main()
