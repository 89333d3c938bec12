"""Server graphs and FL topology.

The paper (Sec. II-A) models inter-server communication as a connected
undirected graph ``G``.  This module builds the standard graph families used
in the simulations and in our benchmarks, derives doubly-stochastic mixing
matrices ``A`` satisfying Eq. (6), and computes the contraction factor

    sigma_A = || A^{T_S} - (1/M) 11' ||_2

that drives Theorem 1.  It also implements *graph surgery* — removing a
failed server and re-deriving a valid mixing matrix — which is the
fault-tolerance story of the multi-server design.

A copy of ``repro.core.topology`` (numpy only): the port imports nothing of
the JAX package, and host-side graph code must agree with it exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# graph construction
# ---------------------------------------------------------------------------


def ring_graph(m: int) -> np.ndarray:
    """Adjacency of a ring (cycle) over ``m`` servers (no self loops)."""
    if m < 2:
        return np.zeros((m, m), dtype=bool)
    adj = np.zeros((m, m), dtype=bool)
    idx = np.arange(m)
    adj[idx, (idx + 1) % m] = True
    adj[(idx + 1) % m, idx] = True
    return adj


def complete_graph(m: int) -> np.ndarray:
    adj = np.ones((m, m), dtype=bool)
    np.fill_diagonal(adj, False)
    return adj


def star_graph(m: int) -> np.ndarray:
    """Server 0 is the hub (degenerates to hierarchical FL — used as the
    baseline topology the paper argues against)."""
    adj = np.zeros((m, m), dtype=bool)
    adj[0, 1:] = True
    adj[1:, 0] = True
    return adj


def line_graph(m: int) -> np.ndarray:
    adj = np.zeros((m, m), dtype=bool)
    i = np.arange(m - 1)
    adj[i, i + 1] = True
    adj[i + 1, i] = True
    return adj


def erdos_renyi_graph(m: int, p: float, seed: int = 0) -> np.ndarray:
    """Random connected graph: sample until connected (adds a ring as a
    fallback spanning structure after 100 tries)."""
    rng = np.random.default_rng(seed)
    for _ in range(100):
        upper = rng.random((m, m)) < p
        adj = np.triu(upper, 1)
        adj = adj | adj.T
        if is_connected(adj):
            return adj
    return ring_graph(m) | adj


def torus_2d_graph(rows: int, cols: int) -> np.ndarray:
    """2-D torus — matches the physical ICI topology of a TPU pod slice, so
    gossip edges ride single physical links."""
    m = rows * cols
    adj = np.zeros((m, m), dtype=bool)
    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            for dr, dc in ((1, 0), (0, 1)):
                j = ((r + dr) % rows) * cols + (c + dc) % cols
                if i != j:
                    adj[i, j] = adj[j, i] = True
    return adj


# ---------------------------------------------------------------------------
# directed graphs (adj[i, j] = True means a link i -> j exists)
#
# An undirected graph is the special case adj == adj.T; everything below
# also accepts that, treating each undirected edge as a bidirectional pair.
# ---------------------------------------------------------------------------


def directed_ring(m: int) -> np.ndarray:
    """Directed cycle 0 -> 1 -> ... -> m-1 -> 0 (strongly connected; its
    out-degree matrix happens to be doubly stochastic because every node has
    out-degree exactly 1 — add chords or drop directions to break that)."""
    adj = np.zeros((m, m), dtype=bool)
    if m >= 2:
        idx = np.arange(m)
        adj[idx, (idx + 1) % m] = True
    return adj


def is_directed(adj: np.ndarray) -> bool:
    """True when some link exists in only one direction."""
    return bool((adj != adj.T).any())


def is_strongly_connected(adj: np.ndarray) -> bool:
    """Directed Assumption-1 check: every server reaches every other along
    link directions.  BFS from node 0 along out-edges and along in-edges
    (reachability in the reverse graph); both covering all nodes is
    equivalent to strong connectivity.  Degenerates to ``is_connected`` on a
    symmetric adjacency."""
    if not is_directed(adj):
        return is_connected(adj)
    return _reaches_all(adj) and _reaches_all(adj.T)


def _reaches_all(adj: np.ndarray) -> bool:
    m = adj.shape[0]
    if m == 0:
        return False
    seen = np.zeros(m, dtype=bool)
    seen[0] = True
    frontier = [0]
    while frontier:
        nxt = []
        for v in frontier:
            for u in np.nonzero(adj[v])[0]:
                if not seen[u]:
                    seen[u] = True
                    nxt.append(u)
        frontier = nxt
    return bool(seen.all())


def random_orientation(adj: np.ndarray, rng: np.random.Generator,
                       ensure_strong: bool = True) -> np.ndarray:
    """Randomly orient every undirected edge (keep exactly one direction).

    Models the realistic degraded regime where each physical link works in
    only one direction.  With ``ensure_strong`` the orientation is repaired
    by re-adding reverse directions (in random order) until the digraph is
    strongly connected — push-sum's Assumption-1 analogue."""
    iu, ju = np.nonzero(np.triu(adj | adj.T, 1))
    out = np.zeros_like(adj)
    flip = rng.random(iu.size) < 0.5
    out[np.where(flip, iu, ju), np.where(flip, ju, iu)] = True
    if ensure_strong and adj.shape[0] > 1 and not is_strongly_connected(out):
        order = rng.permutation(iu.size)
        for e in order:
            out[iu[e], ju[e]] = out[ju[e], iu[e]] = True
            if is_strongly_connected(out):
                break
    return out


def random_direction_drop(adj: np.ndarray, drop_prob: float,
                          rng: np.random.Generator,
                          ensure_strong: bool = True) -> np.ndarray:
    """Asymmetric link degradation: drop each DIRECTION of each edge
    independently with probability ``drop_prob`` — the failure mode (radio
    interference, one-sided congestion) that breaks the symmetry Eq. 6
    assumes.  An edge can lose one direction (becomes directed), both
    (vanishes), or neither.  With ``ensure_strong`` dropped directions are
    re-added (random order) until the digraph is strongly connected.

    Works on directed bases too: only directions PRESENT in ``adj`` are
    candidates (a symmetric adjacency already lists both directions of
    every edge as separate nonzero entries), so degradation can never add
    a reverse link the base graph does not have."""
    di, dj = np.nonzero(adj)
    keep = rng.random(di.size) >= drop_prob
    out = np.zeros_like(adj)
    out[di[keep], dj[keep]] = True
    if ensure_strong and adj.shape[0] > 1 and not is_strongly_connected(out):
        dropped = np.nonzero(~keep)[0]
        rng.shuffle(dropped)
        for e in dropped:
            out[di[e], dj[e]] = True
            if is_strongly_connected(out):
                break
    return out


GRAPH_BUILDERS = {
    "ring": ring_graph,
    "complete": complete_graph,
    "star": star_graph,
    "line": line_graph,
    "directed_ring": directed_ring,
}


def build_graph(kind: str, m: int, **kw) -> np.ndarray:
    if kind == "erdos_renyi":
        return erdos_renyi_graph(m, kw.get("p", 0.5), kw.get("seed", 0))
    if kind == "random_orientation":
        # one-way degraded links: a random strongly-connected orientation of
        # an undirected base family (the generic non-doubly-stochasticisable
        # directed scenario; out-degrees are unequal, so naive row-stochastic
        # gossip on it is biased — see consensus.gossip_push_sum)
        base = build_graph(kw.get("base", "complete"), m)
        return random_orientation(base, np.random.default_rng(kw.get("seed", 0)))
    if kind == "torus":
        rows = kw.get("rows")
        if rows is not None:
            if m % rows:
                raise ValueError(f"torus rows={rows} does not divide M={m}")
        else:
            # largest divisor <= sqrt(M), so the node count is always M even
            # after graph surgery changes M (rows=1 degenerates to a ring —
            # the natural torus of a prime server count)
            rows = max(r for r in range(1, int(np.sqrt(m)) + 1) if m % r == 0)
        return torus_2d_graph(rows, m // rows)
    return GRAPH_BUILDERS[kind](m)


def is_connected(adj: np.ndarray) -> bool:
    """Assumption 1 check (BFS)."""
    m = adj.shape[0]
    if m == 0:
        return False
    if m == 1:
        return True
    seen = np.zeros(m, dtype=bool)
    frontier = [0]
    seen[0] = True
    while frontier:
        nxt = []
        for v in frontier:
            for u in np.nonzero(adj[v])[0]:
                if not seen[u]:
                    seen[u] = True
                    nxt.append(u)
        frontier = nxt
    return bool(seen.all())


# ---------------------------------------------------------------------------
# mixing matrices  (Eq. 6: doubly stochastic, support = G + self loops,
#                   positive entries bounded below by alpha)
# ---------------------------------------------------------------------------


def metropolis_weights(adj: np.ndarray) -> np.ndarray:
    """Metropolis–Hastings weights: symmetric, doubly stochastic, positive on
    the diagonal for any connected graph — the standard constructive choice
    satisfying Eq. (6)."""
    m = adj.shape[0]
    deg = adj.sum(1)
    a = np.zeros((m, m))
    for i in range(m):
        for j in np.nonzero(adj[i])[0]:
            a[i, j] = 1.0 / (1.0 + max(deg[i], deg[j]))
        a[i, i] = 1.0 - a[i].sum()
    return a


def uniform_weights(adj: np.ndarray) -> np.ndarray:
    """Equal-neighbour weights 1/(max_deg+1) — also doubly stochastic."""
    m = adj.shape[0]
    dmax = int(adj.sum(1).max()) if m else 0
    a = adj.astype(float) / (dmax + 1)
    np.fill_diagonal(a, 0.0)
    a += np.diag(1.0 - a.sum(1))
    return a


def check_mixing_matrix(a: np.ndarray, adj: Optional[np.ndarray] = None,
                        atol: float = 1e-10) -> None:
    """Validate Eq. (6): row/col sums 1, non-negative, support matches G."""
    m = a.shape[0]
    if not np.allclose(a.sum(0), 1.0, atol=atol):
        raise ValueError("columns must sum to 1")
    if not np.allclose(a.sum(1), 1.0, atol=atol):
        raise ValueError("rows must sum to 1")
    if (a < -atol).any():
        raise ValueError("entries must be non-negative")
    if adj is not None:
        off = ~np.eye(m, dtype=bool)
        if ((a > atol) & off & ~adj).any():
            raise ValueError("positive weight on a non-edge")


def out_degree_weights(adj: np.ndarray) -> np.ndarray:
    """Row-stochastic mixing weights for a (possibly directed) graph:

        a[i, j] = 1 / (1 + outdeg(i))   for each link i -> j,
        a[i, i] = 1 / (1 + outdeg(i)),

    the directed analogue of ``uniform_weights``: node i splits its mass
    uniformly over its out-neighbourhood plus itself, using only LOCAL
    out-degree knowledge.  Rows always sum to 1; columns sum to 1 only when
    every node has equal out-degree (e.g. a plain directed ring), so in
    general this matrix is NOT doubly stochastic: applied naively
    (``consensus.gossip_scan``) it drives all servers to the Perron-weighted
    average ``pi' W`` rather than the uniform mean — the bias push-sum
    (``consensus.gossip_push_sum``) corrects."""
    m = adj.shape[0]
    a = np.zeros((m, m))
    outdeg = adj.sum(1)
    for i in range(m):
        share = 1.0 / (1.0 + outdeg[i])
        a[i, np.nonzero(adj[i])[0]] = share
        a[i, i] = share
    return a


def check_row_stochastic(a: np.ndarray, adj: Optional[np.ndarray] = None,
                         atol: float = 1e-10) -> None:
    """Validate a directed-gossip mixing matrix: rows sum to 1, entries
    non-negative, positive diagonal (aperiodicity / self-loops), and support
    inside the directed graph when ``adj`` is given.  The column-sum clause
    of Eq. 6 is deliberately NOT required — that is the point of the
    directed regime."""
    m = a.shape[0]
    if not np.allclose(a.sum(1), 1.0, atol=atol):
        raise ValueError("rows must sum to 1")
    if (a < -atol).any():
        raise ValueError("entries must be non-negative")
    if (np.diag(a) <= atol).any():
        raise ValueError("diagonal must be positive (self-loops)")
    if adj is not None:
        off = ~np.eye(m, dtype=bool)
        if ((a > atol) & off & ~adj).any():
            raise ValueError("positive weight on a non-edge")


def perron_weights(a: np.ndarray) -> np.ndarray:
    """The left Perron vector pi of a row-stochastic A (pi' A = pi',
    pi >= 0, sum pi = 1): the stationary weighting that naive gossip
    converges to (``A^t -> 1 pi'``).  Uniform iff A is doubly stochastic."""
    ev, vec = np.linalg.eig(np.asarray(a, np.float64).T)
    k = int(np.argmin(np.abs(ev - 1.0)))
    pi = np.real(vec[:, k])
    pi = np.abs(pi)
    return pi / pi.sum()


def push_sum_deviation(p: np.ndarray) -> float:
    """Contraction of the push-sum RATIO map after mixing with a
    column-stochastic product ``P``: each server's ratio is

        z_i = (P x)_i / (P 1)_i = (row-normalised P · x)_i,

    so the effective averaging operator on the values is P with each row
    divided by its sum — row-stochastic by construction — and its distance
    to exact averaging is ``||rownorm(P) - 11'/M||_2``.  As P approaches its
    rank-one limit ``v 1'`` (column sums are preserved, so sum v = 1) the
    row-normalisation cancels v exactly and this deviation -> 0: the ratio
    is unbiased even though P itself never approaches ``11'/M``."""
    rows = p.sum(1, keepdims=True)
    if (rows <= 0).any():
        raise ValueError("push-sum product has a non-positive weight row")
    return consensus_deviation(p / rows)


def sigma_push_sum(a: np.ndarray, t_s: int) -> float:
    """Push-sum analogue of ``sigma_a``: contraction of the ratio map after
    T_S rounds of mixing with ``P = A'`` (the column-stochastic transpose of
    the row-stochastic A — see ``consensus.gossip_push_sum``)."""
    p = np.linalg.matrix_power(np.asarray(a, np.float64).T, t_s)
    return push_sum_deviation(p)


def consensus_deviation(p: np.ndarray) -> float:
    """||P - (1/M) 11'||_2: how far a (product of) mixing matrices is from
    exact averaging — the common kernel of sigma_a / sigma_product /
    schedule.SigmaTracker."""
    m = p.shape[0]
    return float(np.linalg.norm(p - np.ones((m, m)) / m, ord=2))


def sigma_a(a: np.ndarray, t_s: int) -> float:
    """sigma_A = ||A^{T_S} - (1/M) 11'||_2  (spectral norm) — the consensus
    contraction factor of Lemma 1."""
    return consensus_deviation(np.linalg.matrix_power(a, t_s))


def sigma_product(a_list: Sequence[np.ndarray], t_s: int) -> float:
    """Contraction of a time-varying consensus run: with mixing matrix A_p in
    epoch p applied for T_S rounds each, disagreement contracts by

        || prod_p A_p^{T_S} - (1/M) 11' ||_2

    (each A_p is doubly stochastic, so the product fixes the mean and the
    deviation subspace contracts multiplicatively).  The per-epoch sigma_A of
    Lemma 1 is the single-matrix special case."""
    if not len(a_list):
        raise ValueError("need at least one mixing matrix")
    prod = np.eye(a_list[0].shape[0])
    for a in a_list:
        prod = np.linalg.matrix_power(np.asarray(a, np.float64), t_s) @ prod
    return consensus_deviation(prod)


def drop_edges(adj: np.ndarray, edges: Sequence[Tuple[int, int]]) -> np.ndarray:
    """Remove undirected edges from an adjacency (no-op on non-edges)."""
    out = adj.copy()
    for i, j in edges:
        out[i, j] = out[j, i] = False
    return out


def random_edge_drop(adj: np.ndarray, drop_prob: float,
                     rng: np.random.Generator,
                     ensure_connected: bool = True) -> np.ndarray:
    """Per-epoch link failures: drop each edge independently with probability
    ``drop_prob``.  With ``ensure_connected`` the dropped graph is repaired by
    re-adding removed edges (in random order) until connected again — the
    'degraded but jointly connected' regime where Assumption 1 still holds
    per epoch; without it the graph may transiently disconnect and only the
    *product* contraction (``sigma_product``) is meaningful."""
    m = adj.shape[0]
    iu, ju = np.nonzero(np.triu(adj, 1))
    keep = rng.random(iu.size) >= drop_prob
    out = np.zeros_like(adj)
    out[iu[keep], ju[keep]] = True
    out |= out.T
    if ensure_connected and m > 1 and not is_connected(out):
        dropped = list(np.nonzero(~keep)[0])
        rng.shuffle(dropped)
        for e in dropped:
            out[iu[e], ju[e]] = out[ju[e], iu[e]] = True
            if is_connected(out):
                break
    return out


def weaken_directed_links(a: np.ndarray,
                          links: Sequence[Tuple[int, int]],
                          factor: float) -> np.ndarray:
    """Directed-straggler degradation: scale each listed link DIRECTION
    ``i -> j`` (entry ``a[i, j]`` of a row-stochastic mixing matrix) by
    ``(1 - factor)``, returning the removed mass to the SENDER's self-loop
    ``a[i, i]``.  Rows keep summing to 1, so the result is still a valid
    push-sum operator (its column-stochastic transpose preserves sums and
    the ratio read-out stays unbiased); columns change freely — that
    one-sided asymmetry is exactly what this models and what plain gossip
    cannot absorb.  The directed counterpart of ``weaken_links`` (which
    rebalances BOTH endpoints to preserve symmetry)."""
    if not 0.0 <= factor <= 1.0:
        raise ValueError("weaken factor must be in [0, 1]")
    out = np.asarray(a, np.float64).copy()
    for i, j in links:
        if i == j:
            raise ValueError("cannot weaken a self-loop")
        delta = factor * out[i, j]
        out[i, j] -= delta
        out[i, i] += delta
    return out


def weaken_links(a: np.ndarray, edges: Sequence[Tuple[int, int]],
                 factor: float) -> np.ndarray:
    """Straggler-degraded mixing: scale the weight of each listed edge by
    ``(1 - factor)``, returning the removed mass to the two endpoint
    self-loops.  Symmetry and double stochasticity (Eq. 6) are preserved, so
    the result is still a valid — just slower-contracting — consensus
    operator."""
    if not 0.0 <= factor <= 1.0:
        raise ValueError("weaken factor must be in [0, 1]")
    out = np.asarray(a, np.float64).copy()
    for i, j in edges:
        if i == j:
            raise ValueError("cannot weaken a self-loop")
        delta = factor * out[i, j]
        out[i, j] -= delta
        out[j, i] -= delta
        out[i, i] += delta
        out[j, j] += delta
    return out


def lambda_2(a: np.ndarray) -> float:
    """|lambda_2(A)| of a symmetric doubly-stochastic A — the host-side
    per-epoch spectral estimate spectral consensus backends (Chebyshev)
    consume alongside a traced mixing matrix (``schedule.EpochSchedule``)."""
    ev = np.sort(np.abs(np.linalg.eigvalsh(np.asarray(a, np.float64))))[::-1]
    return float(ev[1]) if len(ev) > 1 else 0.0


def spectral_gap(a: np.ndarray) -> float:
    """1 - |lambda_2(A)| for symmetric doubly-stochastic A."""
    return 1.0 - lambda_2(a)


# ---------------------------------------------------------------------------
# FL topology: servers x clients mapped onto mesh replica slots
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FLTopology:
    """The paper's system model: M servers, N clients each, graph G, epoch
    split (T_C, T_S) — plus the mesh factoring used on hardware."""

    num_servers: int                 # M
    clients_per_server: int          # N
    t_client: int                    # T_C
    t_server: int                    # T_S
    graph_kind: str = "ring"
    mixing: str = "metropolis"       # metropolis | uniform | out_degree
    intra_client_replicas: int = 1   # R: FSDP degree inside one client
    # Explicit adjacency, carried through graph surgery (graph_kind
    # "explicit"): a hashable tuple-of-tuples of bool, row i = out-links of
    # server i.  None for family-built graphs.  drop_server stores the
    # INDUCED subgraph here so removing a server never invents links the
    # survivors do not have (and never resamples a random family).
    explicit_adjacency: Optional[Tuple[Tuple[bool, ...], ...]] = None

    def __post_init__(self):
        if self.num_servers < 1 or self.clients_per_server < 1:
            raise ValueError("need at least 1 server and 1 client")
        if self.t_client < 1 or self.t_server < 0:
            raise ValueError("T_C >= 1, T_S >= 0")
        if self.mixing not in ("metropolis", "uniform", "out_degree"):
            raise ValueError(f"unknown mixing weights {self.mixing!r}")
        if (self.explicit_adjacency is not None) != (
                self.graph_kind == "explicit"):
            raise ValueError("explicit_adjacency and graph_kind='explicit' "
                             "go together: set both (FLTopology."
                             "with_adjacency) or neither")
        adj = self.adjacency()
        if adj.shape[0] != self.num_servers:
            raise ValueError(f"graph family {self.graph_kind!r} built "
                             f"{adj.shape[0]} nodes for M={self.num_servers}")
        if self.num_servers > 1 and not is_strongly_connected(adj):
            raise ValueError("Assumption 1 violated: server graph must be "
                             "(strongly) connected")
        if is_directed(adj) and self.mixing != "out_degree":
            raise ValueError(
                f"graph family {self.graph_kind!r} is directed: symmetric "
                f"{self.mixing!r} weights cannot satisfy Eq. 6 on it — use "
                f"mixing='out_degree' (row-stochastic) with a push-sum "
                f"consensus path")

    # -- graph/mixing --------------------------------------------------------
    def adjacency(self) -> np.ndarray:
        if self.explicit_adjacency is not None:
            return np.asarray(self.explicit_adjacency, dtype=bool)
        return build_graph(self.graph_kind, self.num_servers)

    @staticmethod
    def freeze_adjacency(adj: np.ndarray) -> Tuple[Tuple[bool, ...], ...]:
        """Hashable form of an adjacency matrix (the frozen dataclass must
        stay hashable, so ndarrays cannot be fields)."""
        return tuple(tuple(bool(v) for v in row)
                     for row in np.asarray(adj, dtype=bool))

    def with_adjacency(self, adj: np.ndarray) -> "FLTopology":
        """This topology over an EXPLICIT server graph (the graph-surgery
        carrier): ``num_servers`` follows the matrix, all validation
        (connectivity, directedness vs mixing weights) re-runs."""
        adj = np.asarray(adj, dtype=bool)
        return dataclasses.replace(
            self, num_servers=adj.shape[0], graph_kind="explicit",
            explicit_adjacency=FLTopology.freeze_adjacency(adj))

    @property
    def directed(self) -> bool:
        """True when some server link exists in only one direction (the
        regime where the mixing matrix is row- but not doubly stochastic)."""
        return is_directed(self.adjacency())

    def mixing_matrix(self) -> np.ndarray:
        adj = self.adjacency()
        if self.mixing == "out_degree":
            a = out_degree_weights(adj)
            check_row_stochastic(a, adj)
            return a
        a = metropolis_weights(adj) if self.mixing == "metropolis" else uniform_weights(adj)
        check_mixing_matrix(a, adj)
        return a

    def sigma(self) -> float:
        if self.num_servers == 1:
            return 0.0
        a = self.mixing_matrix()
        if self.mixing == "out_degree":
            # row-stochastic A: the meaningful contraction is that of the
            # push-sum ratio map, not of A^{T_S} itself
            return sigma_push_sum(a, self.t_server)
        return sigma_a(a, self.t_server)

    # -- sizes ---------------------------------------------------------------
    @property
    def num_clients(self) -> int:
        return self.num_servers * self.clients_per_server

    @property
    def epoch_len(self) -> int:  # T_E
        return self.t_client + self.t_server

    @property
    def replica_slots(self) -> int:
        return self.num_clients * self.intra_client_replicas

    # -- Theorem 1 machinery --------------------------------------------------
    def max_step_size(self, mu: float, lsmooth: float) -> float:
        """gamma < min{1/(L T_C), 1/(mu T_C)} (Thm. 1)."""
        return 1.0 / (max(mu, lsmooth) * self.t_client)

    def epsilon_bound(self, gamma: float, mu: float, lsmooth: float,
                      theta: float, w0_disagreement: float = 0.0) -> float:
        """The Thm-1 tolerance  eps = sqrt(M) g th T_C s/(1-s) + Y0/(1-L)."""
        m = self.num_servers
        s = self.sigma()
        tc = self.t_client
        lam = np.sqrt(max(0.0, 1.0 - gamma * mu * tc))
        y0 = ((gamma * tc) ** 2 * theta * lsmooth * (1 + np.sqrt(m) * s / (1 - s))
              + gamma * tc * lsmooth * w0_disagreement)
        return float(np.sqrt(m) * gamma * theta * tc * s / (1 - s) + y0 / (1 - lam))

    # -- fault tolerance -------------------------------------------------------
    def drop_server(self, server_idx: int) -> Tuple["FLTopology", np.ndarray]:
        """Graph surgery after a server failure: remove the node and KEEP
        the induced subgraph if it is still (strongly) connected — carried
        as an explicit adjacency, so no phantom links appear between the
        failed server's neighbours and random families (``erdos_renyi``)
        are never resampled.  When the induced subgraph happens to equal
        the family rebuilt at M-1 (complete minus a node, star minus a
        leaf) the family kind is kept.  If the removal disconnects the
        survivors, fall back to a (directed) ring over them — Assumption 1
        must be restored somehow, and that repair is explicit in the
        returned ``graph_kind``.  Returns (new topology, survivor index
        map)."""
        m = self.num_servers
        if not 0 <= server_idx < m:
            raise ValueError("bad server index")
        if m == 1:
            raise ValueError("cannot drop the only server")
        keep = np.array([i for i in range(m) if i != server_idx])
        sub = self.adjacency()[np.ix_(keep, keep)]
        if not is_strongly_connected(sub):
            fallback = "directed_ring" if self.directed else "ring"
            new = dataclasses.replace(self, num_servers=m - 1,
                                      graph_kind=fallback,
                                      explicit_adjacency=None)
            return new, keep
        if self.explicit_adjacency is None:
            fam = build_graph(self.graph_kind, m - 1)
            if np.array_equal(sub, fam):
                return dataclasses.replace(self, num_servers=m - 1), keep
        return self.with_adjacency(sub), keep

    def rejoin_server(self) -> Tuple["FLTopology", int]:
        """Inverse surgery: a (recovered) server re-enters the federation,
        taking the last index.  For family graphs the family is rebuilt at
        M+1 nodes (the newcomer plugs back into the topology's pattern);
        for an explicit post-surgery graph the newcomer enters fully
        connected to every survivor — it just received the survivor-mean
        model, so links to everyone are the natural bootstrap (and keep the
        graph strongly connected with no further repair).  Returns
        (new topology, insert index)."""
        m = self.num_servers
        if self.explicit_adjacency is None:
            return dataclasses.replace(self, num_servers=m + 1), m
        grown = np.zeros((m + 1, m + 1), dtype=bool)
        grown[:m, :m] = self.adjacency()
        grown[m, :m] = True
        grown[:m, m] = True
        return self.with_adjacency(grown), m
