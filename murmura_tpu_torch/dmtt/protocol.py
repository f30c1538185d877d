"""The DMTT trust protocol as tensor transforms (the PyTorch counterpart of
murmura_tpu/dmtt/protocol.py).

Every directed-edge quantity is one [N, N] tensor, entry [i, j] what
observer i believes about subject j: the link-reliability EMA ĉ_ij, the
Beta evidence (α_ij, β_ij), and from them the topology trust, the model
score and the collaboration score that picks each node's TopB
collaborators.  Claims are verified against the round's true graph G^t.
The exchange of the round is one mask E = C ∧ Cᵀ: node j's broadcast
reaches node i iff j sends to i (i ∈ C_j) and i expects it (j ∈ C_i).

Nothing here synchronises with the host: ``dmtt_selected`` is a carried
scalar tensor, read with ``torch.where`` on the device.

Under a node group's scope (parallel/mesh.py ``node_block_scope``, the node
axis) the round runs on the rank's block of observers: the trust state and
the cross-evaluation are its [R_r, N] rows, while G^t and the claims stay
whole on every rank (the host's graph, the liar's ``claims_fn``), so each
subject's claim counts are whole too.  E = C ∧ Cᵀ reads other observers'
rows: one all_gather of the block's 0/1 collaborator rows
(``gather_mask_rows``, N² bytes) gives every rank the whole C, hence the
whole E; the rest is row-local, TopB's stable order included.
"""

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from murmura_tpu_torch.parallel.mesh import active_node_group, gather_mask_rows

State = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class DMTTParams:
    """Static DMTT hyperparameters (the ``dmtt:`` section)."""

    budget_B: int = 5
    rho: float = 0.1
    lambda_forget: float = 0.9
    w_d: float = 1.0
    # w_c (corroboration) and collab_score's c_comm are kept for config
    # parity; the protocol's round never feeds them non-default values.
    w_c: float = 0.5
    w_x: float = 1.0
    tau_U: float = 0.3
    eta: float = 5.0
    w_a: float = 0.7
    tau_u: float = 0.5
    lambda1: float = 0.4
    lambda2: float = 0.3
    lambda3: float = 0.2
    lambda4: float = 0.1


def init_dmtt_state(num_nodes: int, device="cpu") -> State:
    """The initial trust state.  ``dmtt_selected`` is 0 until the first
    TopB selection: while it is 0 the round uses G^t directly, so that a
    legitimately empty TopB result is not taken for "never selected", and
    a resumed run keeps its learned selection."""
    n = num_nodes
    return {
        "dmtt_c_hat": torch.full((n, n), 0.5, dtype=torch.float32, device=device),
        "dmtt_alpha": torch.ones((n, n), dtype=torch.float32, device=device),
        "dmtt_beta": torch.ones((n, n), dtype=torch.float32, device=device),
        "dmtt_collab": torch.zeros((n, n), dtype=torch.float32, device=device),
        "dmtt_selected": torch.zeros((), dtype=torch.float32, device=device),
    }


def topo_trust(alpha: torch.Tensor, beta: torch.Tensor, p: DMTTParams) -> torch.Tensor:
    """T^topo = R · exp(-η · max(0, U - τ_U)), R the Beta posterior mean and
    U its standard deviation."""
    s = alpha + beta
    r = alpha / s
    u = torch.sqrt(torch.clamp(alpha * beta / (s * s * (s + 1.0)), min=0.0))
    return r * torch.exp(-p.eta * torch.clamp(u - p.tau_U, min=0.0))


def model_score(accuracy: torch.Tensor, u_bar: torch.Tensor, p: DMTTParams) -> torch.Tensor:
    """s^model = (1-ū)(w_a·a + (1-w_a)), times exp(-(ū-τ_u)) above the
    uncertainty threshold, floored at 0."""
    s_base = (1.0 - u_bar) * (p.w_a * accuracy + (1.0 - p.w_a))
    s_base = torch.where(u_bar > p.tau_u, s_base * torch.exp(-(u_bar - p.tau_u)), s_base)
    return torch.clamp(s_base, min=0.0)


def collab_score(s_model: torch.Tensor, t_topo: torch.Tensor, c_hat: torch.Tensor,
                 p: DMTTParams, c_comm: float = 0.0) -> torch.Tensor:
    """q = λ1·s_model + λ2·T^topo + λ3·ĉ - λ4·c_comm."""
    return p.lambda1 * s_model + p.lambda2 * t_topo + p.lambda3 * c_hat - p.lambda4 * c_comm


def _top_b_mask(q: torch.Tensor, valid: torch.Tensor, b: int) -> torch.Tensor:
    """Row-wise B-hot mask of the highest-q valid candidates; a row with
    fewer than B valid candidates keeps them all.  Both sorts are stable,
    as ``jnp.argsort`` is: equal scores rank by index."""
    masked = torch.where(valid, q, torch.full_like(q, float("-inf")))
    order = torch.argsort(-masked, dim=-1, stable=True)
    ranks = torch.argsort(order, dim=-1, stable=True)
    return (valid & (ranks < b)).to(torch.float32)


def dmtt_round_update(
    state: State,
    adj: torch.Tensor,
    claims: torch.Tensor,
    probe_accuracy: torch.Tensor,
    probe_vacuity: torch.Tensor,
    p: DMTTParams,
) -> Tuple[torch.Tensor, State, Dict[str, torch.Tensor]]:
    """One DMTT round over the whole network:

    1. the effective collaborators C (G^t rows before any selection) and
       the exchange mask E = C ∧ Cᵀ;
    2. the link-reliability EMA over each node's expected set (every sent
       message arrives, so the acknowledgement is E);
    3. claim verification against G^t: d_j / x_j count the claimed edges of
       subject j that match / contradict its true row;
    4. the Beta evidence with forgetting, floored at 0.01, on the edges
       that exchanged;
    5. the model scores from the probe cross-evaluation, 0.5 where no model
       arrived;
    6. TopB over the direct G^t neighbours → C^{t+1}.

    ``adj`` is the true [N, N] G^t (0/1 float), ``claims`` the claimed
    adjacency (row j subject j's claim), ``probe_accuracy`` and
    ``probe_vacuity`` [N, N] with [i, j] model j on node i's probe batch.
    Returns (the exchange mask E as float, the new state, per-node stats).
    Under a node scope the state, the probe matrices, the new state and the
    stats are the block's rows and E is whole (module docstring).
    """
    group = active_node_group()
    rows = slice(None) if group is None else slice(*group.rows)
    adj_b = adj > 0
    collab_eff = torch.where(state["dmtt_selected"] > 0, state["dmtt_collab"], adj[rows])
    collab_b = collab_eff > 0
    whole_b = collab_b if group is None else gather_mask_rows(collab_b, group)
    exchange_whole = whole_b & whole_b.T
    exchange = exchange_whole[rows]

    ack = exchange.to(torch.float32)
    c_hat = torch.where(collab_b, (1.0 - p.rho) * state["dmtt_c_hat"] + p.rho * ack,
                        state["dmtt_c_hat"])

    claims_b = claims > 0
    d = (claims_b & adj_b).sum(dim=1).to(torch.float32)  # [N]
    x = (claims_b & ~adj_b).sum(dim=1).to(torch.float32)  # [N]
    alpha_new = p.lambda_forget * state["dmtt_alpha"] + p.w_d * d[None, :]
    beta_new = p.lambda_forget * state["dmtt_beta"] + p.w_x * x[None, :]
    alpha = torch.where(exchange, torch.clamp(alpha_new, min=0.01), state["dmtt_alpha"])
    beta = torch.where(exchange, torch.clamp(beta_new, min=0.01), state["dmtt_beta"])

    s_model = model_score(probe_accuracy, probe_vacuity, p)
    s_model = torch.where(exchange, s_model, torch.full_like(s_model, 0.5))
    t = topo_trust(alpha, beta, p)
    q = collab_score(s_model, t, c_hat, p)
    eye = torch.eye(adj.shape[0], dtype=torch.bool, device=adj.device)
    candidates = (adj_b & ~eye)[rows]
    collab_next = _top_b_mask(q, candidates, p.budget_B)

    new_state = {
        "dmtt_c_hat": c_hat,
        "dmtt_alpha": alpha,
        "dmtt_beta": beta,
        "dmtt_collab": collab_next,
        "dmtt_selected": torch.ones_like(state["dmtt_selected"]),
    }
    cand = candidates.to(torch.float32)
    stats = {
        "dmtt_collab_count": collab_next.sum(dim=1),
        "dmtt_received_count": ack.sum(dim=1),
        "dmtt_mean_topo_trust": (t * cand).sum(dim=1) / torch.clamp(cand.sum(dim=1), min=1.0),
    }
    return exchange_whole.to(torch.float32), new_state, stats
