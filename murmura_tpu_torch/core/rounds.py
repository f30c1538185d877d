"""The FL round (the PyTorch counterpart of the serialized round of
murmura_tpu/core/rounds.py).

    train_step(flat[N, P], agg_state, adj[N, N], compromised[N], round_idx,
               generators=None, draws=None) -> (flat', agg_state', metrics)

1. local training: ``local_epochs`` x masked-batch SGD on every node at
   once — per-node effective batch ``min(B, max(2, n_i))``, sample
   positions ``pos % n_i``, the update masked by ``t < steps_i`` and by the
   honest mask (compromised nodes stay frozen), the update math in float32
   cast back to the parameter dtype;
2. the attack on the broadcast copy only;
3. the aggregation rule over (own, bcast, adj);
4. ``eval_step`` (run by the orchestrator on the ``eval_every`` cadence):
   per-node masked loss and accuracy over the held-out arrays.

The node-stacked flat ``[N, P]`` tensor is the one copy of the parameters;
per-node gradients come from ``torch.func.vmap(torch.func.grad(...))`` over
views into it.  The random draws (the epoch shuffle ``u`` and the attack's
[C, P] noise) come from per-round ``torch.Generator``s, or are injected
through ``draws`` so that a test can feed the JAX package's own draws.
"""

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch.func import grad, vmap

from murmura_tpu_torch.aggregation.base import AggContext, AggregatorDef
from murmura_tpu_torch.attacks.base import Attack
from murmura_tpu_torch.data.base import FederatedArrays
from murmura_tpu_torch.models.core import Model
from murmura_tpu_torch.ops.flatten import (
    make_flatteners,
    tree_leaves,
    tree_map,
    tree_to_torch,
    tree_unflatten,
)
from murmura_tpu_torch.ops.losses import masked_cross_entropy


# Eval samples per chunk (the JAX package's default eval_chunk).
EVAL_CHUNK = 1024


def pin_full_float32() -> None:
    """Keep float32 math in full float32 on the card.  cuDNN runs float32
    convolutions in TF32 by default (about three decimal digits), which
    would make the float32 path disagree with the JAX package and with the
    plain versions; the matmul flag is pinned too so that the setting is
    stated rather than inherited."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@dataclass
class RoundProgram:
    """The round step plus the pieces needed to drive it."""

    train_step: Callable
    eval_step: Callable
    init_flat: torch.Tensor  # [N, P]
    init_agg_state: Dict[str, torch.Tensor]
    data: Dict[str, torch.Tensor]
    num_nodes: int
    model_dim: int
    unravel: Callable
    device: torch.device


def round_generators(seed: int, round_idx: int, device) -> Dict[str, torch.Generator]:
    """Per-round generators for the shuffle and the attack noise: a pure
    function of (seed, round), like the JAX package's fold_in(key, round)."""
    train_seed, attack_seed = np.random.SeedSequence([seed, round_idx]).generate_state(2)
    gens = {}
    for name, s in (("train", train_seed), ("attack", attack_seed)):
        g = torch.Generator(device=device)
        g.manual_seed(int(s))
        gens[name] = g
    return gens


def init_stacked_params(model: Model, n: int, seed: int, device) -> Any:
    """Initial [N, ...]-stacked params, node after node from one generator."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    per_node = [model.init(g, device) for _ in range(n)]
    leaves = [tree_leaves(p) for p in per_node]
    return tree_unflatten(
        per_node[0], [torch.stack(group) for group in zip(*leaves)]
    )


def build_round_program(
    model: Model,
    agg: AggregatorDef,
    data: FederatedArrays,
    *,
    local_epochs: int = 1,
    batch_size: int = 64,
    lr: float = 0.01,
    total_rounds: int = 20,
    attack: Optional[Attack] = None,
    seed: int = 42,
    param_dtype: Optional[str] = None,
    device="cuda",
    init_params: Any = None,
) -> RoundProgram:
    """Round step for a network of ``data.num_nodes`` nodes on ``device``
    (the card unless the caller asks for the CPU; without CUDA a ``cuda``
    device raises).

    ``init_params`` (a node-stacked pytree of tensors or numpy arrays in the
    JAX package's layout) replaces the seeded initialisation — the weight
    carry-over the tests use.  ``total_rounds`` is the T of the rules'
    threshold schedules.
    """
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: build_round_program runs on the card "
                "by default; pass device='cpu' to run on the CPU"
            )
        pin_full_float32()
    n = data.num_nodes
    if model.evidential:
        raise ValueError("evidential models are not ported to the PyTorch package yet")

    eff_batch_np = data.effective_batch(batch_size)
    steps_np = data.steps_per_epoch(batch_size)
    max_steps = int(steps_np.max())
    global_batch = int(eff_batch_np.max())

    if init_params is None:
        stacked = init_stacked_params(model, n, seed, device)
    else:
        stacked = tree_to_torch(init_params, device, torch.float32)
    template = tree_map(lambda l: l[0], stacked)
    ravel, unravel, model_dim = make_flatteners(template)
    pdt = torch.float32 if param_dtype in (None, "float32") else getattr(torch, param_dtype)
    init_flat = ravel(stacked, batch_dims=1).to(pdt).contiguous()

    def dev(a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(device)

    eval_x, eval_y, eval_mask = data.eval_arrays
    d = {
        "x": dev(data.x, torch.float32),
        "y": dev(data.y, torch.int64),
        "mask": dev(data.mask, torch.float32),
        "num_samples": dev(data.num_samples, torch.int64),
        "eff_batch": dev(eff_batch_np, torch.int64),
        "steps": dev(steps_np, torch.int64),
        "eval_x": dev(eval_x, torch.float32),
        "eval_y": dev(eval_y, torch.int64),
        "eval_mask": dev(eval_mask, torch.float32),
    }
    nodes = torch.arange(n, device=device)

    def node_loss(params_i, xb, yb, mb):
        loss, _ = masked_cross_entropy(model.apply(params_i, xb), yb, mb)
        return loss

    grad_fn = vmap(grad(node_loss))

    def local_training(flat, train_mask, generator, u_draws):
        """local_epochs x masked-batch SGD; updates ``flat`` in place."""
        j = torch.arange(global_batch, device=device)
        batch_mask = (j[None, :] < d["eff_batch"][:, None]).to(torch.float32)
        samples = torch.clamp(d["num_samples"], min=1)[:, None]
        params = unravel(flat)
        for epoch in range(local_epochs):
            if u_draws is not None:
                u = torch.as_tensor(u_draws[epoch], dtype=torch.float32).to(device)
            else:
                u = torch.rand(
                    d["mask"].shape, generator=generator, device=device,
                    dtype=torch.float32,
                )
            # Shuffle valid samples to the front: invalid slots sort last.
            perm = torch.argsort(u + (1.0 - d["mask"]) * 10.0, dim=1, stable=True)
            for t in range(max_steps):
                pos = (t * d["eff_batch"][:, None] + j[None, :]) % samples
                idx = torch.gather(perm, 1, pos)  # [N, B]
                xb = d["x"][nodes[:, None], idx]
                yb = d["y"][nodes[:, None], idx]
                grads = grad_fn(params, xb, yb, batch_mask)
                update = train_mask * (t < d["steps"]).to(torch.float32)  # [N]
                with torch.no_grad():
                    for p, g in zip(tree_leaves(params), tree_leaves(grads)):
                        ub = update.reshape((n,) + (1,) * (p.dim() - 1))
                        p.copy_((p - (lr * ub) * g.to(torch.float32)).to(p.dtype))
        return flat

    ctx = AggContext(total_rounds=total_rounds)

    def train_step(
        flat: torch.Tensor,
        agg_state: Dict[str, torch.Tensor],
        adj: torch.Tensor,
        compromised: torch.Tensor,
        round_idx: float,
        generators: Optional[Dict[str, torch.Generator]] = None,
        draws: Optional[Dict[str, Any]] = None,
    ):
        generators = generators or {}
        draws = draws or {}
        honest = 1.0 - compromised
        train_mask = (
            torch.ones_like(honest)
            if attack is not None and attack.trains_locally
            else honest
        )
        own_flat = local_training(
            flat.clone(), train_mask, generators.get("train"), draws.get("u")
        )
        if attack is not None:
            noise = draws.get("noise")
            if noise is not None:
                noise = torch.as_tensor(np.asarray(noise)).to(device)
            bcast = attack.apply(
                own_flat, compromised, generators.get("attack"), noise=noise
            )
        else:
            bcast = own_flat
        new_flat, agg_state, agg_stats = agg.aggregate(
            own_flat, bcast, adj, round_idx, agg_state, ctx
        )
        metrics = {f"agg_{k}": v for k, v in agg_stats.items()}
        return new_flat, agg_state, metrics

    apply_nodes = vmap(model.apply)

    @torch.no_grad()
    def eval_step(flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        x, y, mask = d["eval_x"], d["eval_y"], d["eval_mask"]
        params = unravel(flat)
        s = x.shape[1]
        chunk = max(1, min(EVAL_CHUNK, s))
        loss = torch.zeros(n, device=device)
        correct = torch.zeros(n, device=device)
        count = torch.zeros(n, device=device)
        for c0 in range(0, s, chunk):
            xc, yc, mc = x[:, c0:c0 + chunk], y[:, c0:c0 + chunk], mask[:, c0:c0 + chunk]
            outputs = apply_nodes(params, xc)  # [N, c, K]
            logp = torch.log_softmax(outputs, dim=-1)
            nll = -torch.gather(logp, -1, yc[..., None])[..., 0]
            loss += (nll * mc).sum(dim=1)
            correct += ((torch.argmax(outputs, -1) == yc).to(torch.float32) * mc).sum(dim=1)
            count += mc.sum(dim=1)
        total = torch.clamp(count, min=1.0)
        return {"loss": loss / total, "accuracy": correct / total}

    init_agg_state = {
        k: torch.as_tensor(np.asarray(v)).to(device) for k, v in agg.init_state(n).items()
    }
    return RoundProgram(
        train_step=train_step,
        eval_step=eval_step,
        init_flat=init_flat,
        init_agg_state=init_agg_state,
        data=d,
        num_nodes=n,
        model_dim=model_dim,
        unravel=unravel,
        device=device,
    )
