"""No-U-Turn sampler, the iterative multinomial form: port of
``normflows_tpu/sampling/nuts.py`` (Betancourt 2017's multinomial weights
and generalised U-turn criterion; the iterative subtree with the
binary-counter checkpoint stacks).

The chains advance in lock-step on the batch axis with masked lanes, as the
JAX package's ``vmap`` of ``lax.while_loop`` does: a lane whose tree has
turned or diverged is frozen by ``torch.where`` and stops accumulating.

**The loop form.**  A transition is a Python loop over doublings (at most
``max_depth``); doubling ``d`` runs its subtree's ``2^d`` leaves as a
Python loop.  Every active lane shares the leaf index, so a leaf's
checkpoint slot ``popcount(i)``, the slot range it checks and ``is_even``
are the same for all lanes: a table on the device holds them by leaf, and
the U-turn check is one vectorised comparison over the
``(max_depth, chains, dim)`` checkpoint stacks, the slots outside the
range masked (JAX: a ``fori_loop`` over slots).  A leaf updates the
subtree's state in place, so that on a card it is captured once in a CUDA
graph and each leaf is one replay (eager on the CPU).  The host reads
the device once a doubling ("is any lane still active") and, inside a
subtree, before leaves 2, 4, 8, ... ("is any lane still building"), to
stop once every lane has stopped; ``host_reads`` keeps the count and
``leaves`` the leaves run.  A lane whose subtree stops early keeps its
state while the others run on, so the leaves run a transition are those of
the deepest lane (JAX's vmapped while loop runs them too, each lane
masked); the values are JAX's.

A leaf computes the target's gradient once, at its new point, and carries
it with the trajectory's ends; the JAX package recomputes the gradient at
the start of every leapfrog step, which is the previous end's.

**Draws.**  A transition takes ``noise = (p, u_dir, u_acc, u_take)``: the
momentum normals (chains, dim), the direction and subtree-accept uniforms
(max_depth, chains) and the leaf uniforms (max_depth, 2^(max_depth-1),
chains); doubling ``d`` reads row ``d`` and its leaf ``i`` reads
``u_take[d, i]``.  A frozen lane ignores its draws.  A ``generator`` draws
them in that order, all of them, at the start of the transition.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..ops.backend import capturing, resolve_device
from .adaptation import dual_averaging_init, dual_averaging_update


def trailing_ones(i: int) -> int:
    """The number of trailing 1-bits of ``i`` (the size class of the blocks
    that end at leaf ``i``)."""
    n = i + 1
    return bin((n & -n) - 1).count("1")


def ckpt_slot_range(i: int):
    """``(idx_min, idx_max)`` of the checkpoint slots that hold the start
    states of the blocks odd leaf ``i`` completes; empty (idx_max <
    idx_min) for an even ``i``."""
    idx_min = bin(i + 1).count("1") - 1
    return idx_min, idx_min + trailing_ones(i) - 1


def _rows(mask, z):
    return mask.reshape(-1, *([1] * (z.dim() - 1)))


class NUTS(nn.Module):
    """Multinomial No-U-Turn sampler over a batched ``target.log_prob``
    ((chains, dim) -> (chains,)); ``step_size`` is a scalar buffer (tuned
    by :meth:`sample`'s warm-up) and ``inv_mass`` the diagonal inverse
    mass (dim,)."""

    def __init__(self, target: nn.Module, step_size, inv_mass, max_depth: int = 8,
                 max_delta_energy: float = 1000.0):
        super().__init__()
        self.target = target
        self.register_buffer("step_size", torch.as_tensor(step_size, dtype=torch.float32))
        self.register_buffer("inv_mass", torch.as_tensor(inv_mass, dtype=torch.float32))
        self.max_depth = max_depth
        self.max_delta_energy = max_delta_energy
        self.host_reads = 0  # device reads of the last transition
        self.leaves = 0  # leaf steps the last transition ran (each lane's or not)

    @classmethod
    def create(cls, target, dim: int, step_size: float = 0.1, inv_mass=None,
               max_depth: int = 8, *, device="cuda"):
        device = resolve_device(device)
        inv_mass = (torch.ones(dim, device=device) if inv_mass is None
                    else torch.as_tensor(inv_mass, dtype=torch.float32).to(device))
        return cls(target, torch.tensor(step_size, dtype=torch.float32, device=device),
                   inv_mass, max_depth)

    # -- pieces on all chains at once -----------------------------------------

    def _log_prob_and_grad(self, z):
        with torch.enable_grad():
            z_ = z.detach().requires_grad_(True)
            log_p = self.target.log_prob(z_)
            (grad,) = torch.autograd.grad(log_p.sum(), z_)
        return log_p.detach(), grad

    def _kinetic(self, p, inv_mass):
        return 0.5 * torch.sum(p * p * inv_mass, dim=-1)

    def _is_turning(self, r_left, r_right, r_sum, inv_mass):
        """Generalised U-turn criterion (Betancourt 2017, app. A.4.2) on the
        last axis; leading axes broadcast."""
        r_c = r_sum - 0.5 * (r_left + r_right)
        at_left = torch.sum(r_left * inv_mass * r_c, dim=-1) <= 0.0
        at_right = torch.sum(r_right * inv_mass * r_c, dim=-1) <= 0.0
        return at_left | at_right

    def draw_noise(self, num_chains: int, dim: int, *,
                   generator: Optional[torch.Generator] = None, device=None):
        """One transition's draws, in the documented order."""
        device = self.inv_mass.device if device is None else device
        kw = dict(generator=generator, dtype=self.inv_mass.dtype, device=device)
        return (torch.randn(num_chains, dim, **kw),
                torch.rand(self.max_depth, num_chains, **kw),
                torch.rand(self.max_depth, num_chains, **kw),
                torch.rand(self.max_depth, 2 ** (self.max_depth - 1), num_chains, **kw))

    def _any(self, mask) -> bool:
        self.host_reads += 1
        return bool(mask.any())

    def _leaf_buffers(self, B, dim, dtype, device):
        """The subtree's state and a leaf's inputs as tensors that live
        across calls (a captured leaf reads and writes them in place), one
        set for each batch shape; and the leaf table, each leaf's host
        integers (is_even, its checkpoint slot, the slot range it checks)
        as a device tensor."""
        key = (B, dim, dtype, torch.device(device))
        cache = self.__dict__.setdefault("_leaf_cache", {})
        if key not in cache:
            kw = dict(dtype=dtype, device=device)
            leaves = 1 << (self.max_depth - 1)
            table = [(int(i % 2 == 0), bin(i).count("1") if i % 2 == 0 else 0,
                      *ckpt_slot_range(i)) for i in range(leaves)]
            s = {"z": torch.zeros(B, dim, **kw), "p": torch.zeros(B, dim, **kw),
                 "g": torch.zeros(B, dim, **kw), "z_prop": torch.zeros(B, dim, **kw),
                 "log_w": torch.zeros(B, **kw), "p_cumsum": torch.zeros(B, dim, **kw),
                 "r_ckpts": torch.zeros(self.max_depth, B, dim, **kw),
                 "rsum_ckpts": torch.zeros(self.max_depth, B, dim, **kw),
                 "turning": torch.zeros(B, dtype=torch.bool, device=device),
                 "diverging": torch.zeros(B, dtype=torch.bool, device=device),
                 "acc_sum": torch.zeros(B, **kw),
                 "acc_cnt": torch.zeros(B, dtype=torch.int32, device=device),
                 "pick": torch.zeros(B, dtype=torch.int64, device=device)}
            c = {"eps": torch.zeros(B, 1, **kw), "energy0": torch.zeros(B, **kw),
                 "active": torch.zeros(B, dtype=torch.bool, device=device),
                 "inv_mass": torch.zeros(dim, **kw), "u": torch.zeros(leaves, B, **kw),
                 "i": torch.zeros(1, dtype=torch.int64, device=device),
                 "table": torch.tensor(table, dtype=torch.int64, device=device),
                 "slots": torch.arange(self.max_depth, device=device)}
            cache[key] = {"s": s, "c": c, "graph": None}
        return cache[key]

    def _leaf(self, s, c):
        """Leaf ``c["i"]`` of the subtree on every lane, in place: a leapfrog
        step from (z, p) with the gradient g at z carried from the last
        leaf, the multinomial proposal (``pick``: the leaf it took), the
        checkpoint and the U-turn check, each lane's state kept where it no
        longer builds; then ``i`` + 1."""
        row = c["table"].index_select(0, c["i"])[0]
        is_even, slot, lo, hi = row[0] == 1, row[1:2], row[2], row[3]
        eps, inv_mass = c["eps"], c["inv_mass"]
        building = c["active"] & ~s["turning"] & ~s["diverging"]
        p_new = s["p"] + 0.5 * eps * s["g"]
        z_new = s["z"] + eps * p_new * inv_mass
        log_p, g_new = self._log_prob_and_grad(z_new)
        p_new = p_new + 0.5 * eps * g_new
        delta = -log_p + self._kinetic(p_new, inv_mass) - c["energy0"]
        delta = torch.where(torch.isfinite(delta), delta, math.inf)
        diverging = delta > self.max_delta_energy
        # progressive multinomial proposal within the subtree
        log_w_leaf = -delta
        log_w_new = torch.logaddexp(s["log_w"], log_w_leaf)
        take = torch.log(c["u"].index_select(0, c["i"])[0]) < log_w_leaf - log_w_new
        z_prop = torch.where(_rows(take, z_new), z_new, s["z_prop"])
        # even leaves open blocks: the momentum and the sum before it go to
        # the slot popcount(i)
        write = (is_even & building)[None, :, None]
        r_slot = torch.where(write, p_new[None], s["r_ckpts"].index_select(0, slot))
        rsum_slot = torch.where(write, s["p_cumsum"][None],
                                s["rsum_ckpts"].index_select(0, slot))
        s["r_ckpts"].index_copy_(0, slot, r_slot)
        s["rsum_ckpts"].index_copy_(0, slot, rsum_slot)
        p_cumsum = s["p_cumsum"] + p_new
        # odd leaves close blocks: the U-turn check against every completed
        # block's start checkpoint, the slots [lo, hi], in one comparison
        in_range = ((c["slots"] >= lo) & (c["slots"] <= hi))[:, None]
        turning = (in_range & self._is_turning(s["r_ckpts"], p_new,
                                               p_cumsum - s["rsum_ckpts"],
                                               inv_mass)).any(dim=0)
        new = {"z": z_new, "p": p_new, "g": g_new, "z_prop": z_prop, "log_w": log_w_new,
               "pick": torch.where(take, c["i"], s["pick"]),
               "p_cumsum": p_cumsum, "turning": turning, "diverging": diverging,
               "acc_sum": s["acc_sum"] + torch.clamp(torch.exp(-delta), max=1.0),
               "acc_cnt": s["acc_cnt"] + 1}
        for k, v in new.items():  # a lane that stopped keeps its state
            s[k].copy_(torch.where(building if v.dim() == 1 else _rows(building, v), v, s[k]))
        c["i"].add_(1)

    def _leaf_graph(self, bufs):
        """The leaf captured once in a CUDA graph on ``bufs`` (after a
        warm-up on a side stream; the caller sets the state afterwards)."""
        if bufs["graph"] is None:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                bufs["c"]["i"].zero_()
                self._leaf(bufs["s"], bufs["c"])
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                self._leaf(bufs["s"], bufs["c"])
            bufs["graph"] = graph
        return bufs["graph"]

    def _subtree(self, d, z, p, g, eps, energy0, active, inv_mass, u_take):
        """Doubling ``d``'s subtree of 2^d leaves from (z, p, grad g) with the
        signed step ``eps`` (chains, 1), on the lanes ``active``: its state,
        tensors that the next subtree overwrites."""
        B, dim = z.shape
        bufs = self._leaf_buffers(B, dim, z.dtype, z.device)
        graph = self._leaf_graph(bufs) if z.is_cuda and not capturing() else None
        s, c = bufs["s"], bufs["c"]
        for k, v in (("z", z), ("p", p), ("g", g), ("z_prop", z)):
            s[k].copy_(v)
        s["log_w"].fill_(-math.inf)
        s["pick"].fill_(-1)
        for k in ("p_cumsum", "r_ckpts", "rsum_ckpts", "turning", "diverging", "acc_sum",
                  "acc_cnt"):
            s[k].zero_()
        for k, v in (("eps", eps), ("energy0", energy0), ("active", active),
                     ("inv_mass", inv_mass)):
            c[k].copy_(v)
        c["u"][:1 << d].copy_(u_take[:1 << d])
        c["i"].zero_()
        for i in range(1 << d):
            if i > 1 and (i & (i - 1)) == 0 and not self._any(
                    active & ~s["turning"] & ~s["diverging"]):
                break
            self.leaves += 1
            if graph is None:
                self._leaf(s, c)
            else:
                graph.replay()
        return s

    def _transition(self, z, step_size, inv_mass, noise):
        self.host_reads = self.leaves = 0
        p_eps, u_dir, u_acc, u_take = (torch.as_tensor(a, dtype=z.dtype, device=z.device)
                                       for a in noise)
        B = z.shape[0]
        p0 = p_eps / torch.sqrt(inv_mass)
        log_p0, g0 = self._log_prob_and_grad(z)
        energy0 = -log_p0 + self._kinetic(p0, inv_mass)
        false = torch.zeros(B, dtype=torch.bool, device=z.device)
        t = {"z_left": z, "p_left": p0, "g_left": g0, "z_right": z, "p_right": p0,
             "g_right": g0, "z_prop": z, "log_w": z.new_zeros(B), "p_sum": p0,
             "depth": torch.zeros(B, dtype=torch.int32, device=z.device), "turning": false,
             "diverging": false, "acc_sum": z.new_zeros(B),
             "acc_cnt": torch.zeros(B, dtype=torch.int32, device=z.device)}
        # the leaf of each doubling's subtree whose draw became the proposal
        picks = torch.full((self.max_depth, B), -1, dtype=torch.int64, device=z.device)
        for d in range(self.max_depth):
            active = ~t["turning"] & ~t["diverging"]
            if d > 0 and not self._any(active):
                break
            right = u_dir[d] < 0.5
            r2 = _rows(right, z)
            z0 = torch.where(r2, t["z_right"], t["z_left"])
            p0e = torch.where(r2, t["p_right"], t["p_left"])
            g0e = torch.where(r2, t["g_right"], t["g_left"])
            eps = step_size * torch.where(right, 1.0, -1.0)[:, None]
            sub = self._subtree(d, z0, p0e, g0e, eps, energy0, active, inv_mass, u_take[d])
            valid = ~sub["turning"] & ~sub["diverging"]
            # biased progressive sampling across subtrees (favours the new one)
            accept_new = torch.log(u_acc[d]) < sub["log_w"] - t["log_w"]
            picks[d] = torch.where(active & valid & accept_new, sub["pick"], -1)
            left_v, right_v = _rows(valid & ~right, z), _rows(valid & right, z)
            new = {
                "z_prop": torch.where(_rows(valid & accept_new, z), sub["z_prop"], t["z_prop"]),
                "log_w": torch.where(valid, torch.logaddexp(t["log_w"], sub["log_w"]),
                                     t["log_w"]),
                "z_left": torch.where(left_v, sub["z"], t["z_left"]),
                "p_left": torch.where(left_v, sub["p"], t["p_left"]),
                "g_left": torch.where(left_v, sub["g"], t["g_left"]),
                "z_right": torch.where(right_v, sub["z"], t["z_right"]),
                "p_right": torch.where(right_v, sub["p"], t["p_right"]),
                "g_right": torch.where(right_v, sub["g"], t["g_right"]),
                "p_sum": torch.where(_rows(valid, z), t["p_sum"] + sub["p_cumsum"], t["p_sum"]),
            }
            turning_top = valid & self._is_turning(new["p_left"], new["p_right"], new["p_sum"],
                                                   inv_mass)
            new.update({"depth": t["depth"] + 1, "turning": sub["turning"] | turning_top,
                        "diverging": sub["diverging"],
                        "acc_sum": t["acc_sum"] + sub["acc_sum"],
                        "acc_cnt": t["acc_cnt"] + sub["acc_cnt"]})
            for k, v in new.items():
                t[k] = torch.where(active if v.dim() == 1 else _rows(active, v), v, t[k])
        accept_prob = t["acc_sum"] / torch.clamp(t["acc_cnt"], min=1)
        stats = {"accept_prob": accept_prob, "depth": t["depth"],
                 "diverging": t["diverging"], "num_leapfrog": t["acc_cnt"], "picks": picks}
        return t["z_prop"], stats

    # -- batched API ---------------------------------------------------------

    def transition(self, z, step_size=None, *, generator: Optional[torch.Generator] = None,
                   noise=None, inv_mass=None):
        """One NUTS step for ``z`` (chains, dim): ``(z_new, stats)`` with
        ``accept_prob``, ``depth``, ``diverging`` and ``num_leapfrog`` a
        chain, and ``picks`` (max_depth, chains): the leaf of doubling d's
        subtree whose draw replaced the proposal, -1 where none did (with
        the depth and the directions, they fix which leaf ``z_new`` is).
        ``noise`` (see the module's docstring) or ``generator``."""
        if noise is None:
            if generator is None:
                raise ValueError("NUTS.transition draws: pass generator= (or its draws as "
                                 "noise=)")
            noise = self.draw_noise(z.shape[0], z.shape[1], generator=generator,
                                    device=z.device)
        step_size = self.step_size if step_size is None else step_size
        inv_mass = self.inv_mass if inv_mass is None else inv_mass
        with torch.no_grad():
            return self._transition(z, step_size, inv_mass, noise)

    def sample(self, num_chains: int, num_steps: int, initial=None, num_adapt: int = 100,
               target_accept: float = 0.8, adapt_mass: bool = True, *,
               generator: Optional[torch.Generator] = None, noise=None):
        """Warm-up (dual averaging of the step size and, with ``adapt_mass``,
        Stan's two phases: the diagonal inverse mass from the first window's
        moments, then the step size adapted anew from its averaged iterate),
        then ``num_steps`` transitions.  Returns ``(samples (num_steps,
        num_chains, dim), info)``, ``info`` with ``step_size``, ``inv_mass``,
        ``accept_prob`` (num_steps, num_chains), ``mean_depth``,
        ``divergence_rate`` and ``host_reads`` (over the sampling steps);
        ``depth`` and ``num_leapfrog`` a step and chain, ``picks`` a step
        (see :meth:`transition`); over every
        transition, the warm-up's included, ``transitions``,
        ``leaves_total`` (the leaf steps run in lock-step) and
        ``host_reads_total``.

        ``generator`` draws the initial states (standard normals, unless
        ``initial`` is given), then each transition's draws in turn;
        ``noise = (z_init or None, [one transition's noise, ...])`` replays
        them, the transitions in the order they run (the two warm-up
        windows, then the sampling steps)."""
        if noise is None and generator is None:
            raise ValueError("NUTS.sample draws: pass generator= (or its draws as noise=)")
        dim = self.inv_mass.shape[0]
        kw = dict(dtype=self.inv_mass.dtype, device=self.inv_mass.device)
        if initial is not None:
            z = torch.as_tensor(initial, **kw)
        elif noise is not None:
            z = torch.as_tensor(noise[0], **kw)
        else:
            z = torch.randn(num_chains, dim, generator=generator, **kw)
        count = [0]
        work = {"leaves_total": 0, "host_reads_total": 0}

        def transition(z, step_size, inv_mass):
            nz = None if noise is None else noise[1][count[0]]
            count[0] += 1
            out = self.transition(z, step_size, generator=generator, noise=nz,
                                  inv_mass=inv_mass)
            work["leaves_total"] += self.leaves
            work["host_reads_total"] += self.host_reads
            return out

        inv_mass = self.inv_mass
        da = dual_averaging_init(self.step_size)

        def warm_phase(z, da, inv_mass, n_steps):
            n, sm, s2 = z.new_zeros(()), z.new_zeros(dim), z.new_zeros(dim)
            for _ in range(n_steps):
                z, tr = transition(z, torch.exp(da.log_step), inv_mass)
                da = dual_averaging_update(da, torch.mean(tr["accept_prob"]),
                                           target=target_accept)
                n, sm, s2 = n + z.shape[0], sm + z.sum(0), s2 + (z * z).sum(0)
            return z, da, (n, sm, s2)

        if num_adapt > 0 and adapt_mass:
            n_a = max(1, num_adapt // 2)
            z, da, (n, sm, s2) = warm_phase(z, da, inv_mass, n_a)
            mean = sm / n
            var = torch.clamp(s2 / n - mean * mean, min=1e-6)
            # Stan's regularisation toward unit mass for short windows
            inv_mass = n / (n + 5.0) * var + 1e-3 * (5.0 / (n + 5.0))
            da = dual_averaging_init(torch.exp(da.log_step_avg))
            z, da, _ = warm_phase(z, da, inv_mass, max(1, num_adapt - n_a))
        elif num_adapt > 0:
            z, da, _ = warm_phase(z, da, inv_mass, num_adapt)
        step_size = torch.exp(da.log_step_avg)
        zs, stats, reads = [], [], 0
        for _ in range(num_steps):
            z, st = transition(z, step_size, inv_mass)
            zs.append(z)
            stats.append(st)
            reads += self.host_reads
        depth = torch.stack([s["depth"] for s in stats])
        info = {"step_size": step_size, "inv_mass": inv_mass,
                "accept_prob": torch.stack([s["accept_prob"] for s in stats]),
                "mean_depth": torch.mean(depth.float()),
                "divergence_rate": torch.mean(torch.stack(
                    [s["diverging"] for s in stats]).float()),
                "depth": depth,
                "num_leapfrog": torch.stack([s["num_leapfrog"] for s in stats]),
                "picks": torch.stack([s["picks"] for s in stats]),
                "host_reads": reads, "transitions": count[0], **work}
        return torch.stack(zs), info
