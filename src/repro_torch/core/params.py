"""Parameter derivation for DB-LSH (paper §III-C, §V).

Given (n, c, w0, t) this module derives

    p1   = p(1; w0),  p2 = p(c; w0)              (Lemma 1)
    rho* = ln(1/p1) / ln(1/p2)
    K    = ceil( log_{1/p2}(n / t) )
    L    = ceil( (n / t)^{rho*} )

and the Lemma-3 bound machinery:

    alpha(gamma) = gamma * f(gamma) / ∫_gamma^∞ f(x) dx      (= xi(gamma))
    rho* <= 1 / c^alpha  for  w0 = 2 gamma c^2.

At gamma = 2 (w0 = 4 c^2) alpha = 4.7467 — the paper's headline constant.
All of it is float64 host math, a copy of ``repro.core.params`` so that
derived fields agree with the reference field for field.
"""

from __future__ import annotations

import dataclasses
import math

from .hashing import collision_prob

__all__ = ["DBLSHParams", "alpha_of_gamma", "rho_star", "collision_prob"]


def _p(tau: float, w: float) -> float:
    """Closed-form collision probability (float64 host-side twin of Eq. 4)."""
    return math.erf(w / (2.0 * math.sqrt(2.0) * tau))


def _log_inv_p(tau: float, w: float) -> float:
    """ln(1/p(tau; w)) computed stably when p -> 1 (large w/tau):
    ln(1/p) = -log1p(-erfc(x)), erfc keeps precision where erf saturates."""
    x = w / (2.0 * math.sqrt(2.0) * tau)
    ec = math.erfc(x)
    if ec >= 1.0:
        return math.inf
    return -math.log1p(-ec)


def _log_erfc(x: float) -> float:
    """log(erfc(x)) without underflow (asymptotic expansion past x ~ 25)."""
    if x < 25.0:
        return math.log(math.erfc(x))
    # erfc(x) ~ exp(-x^2) / (x sqrt(pi)) * (1 - 1/(2x^2) + ...)
    return -x * x - math.log(x * math.sqrt(math.pi)) + math.log1p(-0.5 / (x * x))


def _log_log_inv_p(tau: float, w: float) -> float:
    """log( ln(1/p(tau; w)) ), stable over the entire width range."""
    x = w / (2.0 * math.sqrt(2.0) * tau)
    ec = math.erfc(x)
    if ec > 1e-8:
        return math.log(-math.log1p(-ec))
    # ln(1/p) = -log1p(-ec) ~ ec for tiny ec, so log(ln(1/p)) ~ log(ec).
    return _log_erfc(x)


def alpha_of_gamma(gamma: float) -> float:
    """xi(gamma) = gamma f(gamma) / ∫_gamma^∞ f  (Lemma 3).

    Monotonically increasing for gamma > 0; xi(2) = 4.7467.
    """
    pdf = math.exp(-0.5 * gamma * gamma) / math.sqrt(2.0 * math.pi)
    sf = 0.5 * (1.0 - math.erf(gamma / math.sqrt(2.0)))
    return gamma * pdf / sf


def rho_star(c: float, w0: float) -> float:
    """rho* = ln(1/p1)/ln(1/p2) with p1 = p(1; w0), p2 = p(c; w0).

    Computed in log space so it stays positive and accurate even when the
    collision probabilities are within 1e-300 of 1 (very wide buckets)."""
    return math.exp(log_rho_star(c, w0))


def log_rho_star(c: float, w0: float) -> float:
    """log(rho*) — usable even where rho* itself underflows float64."""
    return _log_log_inv_p(1.0, w0) - _log_log_inv_p(c, w0)


@dataclasses.dataclass(frozen=True)
class DBLSHParams:
    """Resolved DB-LSH hyper-parameters (the reference's field set).

    ``block_size``/``max_blocks`` are the static-shape knobs of the
    fixed-capacity window scan (DESIGN.md §3); the paper's candidate
    budget 2tL + k is enforced through them.  ``use_kernel`` and
    ``quant_dtype`` are kept so that a reference index's params carry
    across unchanged; ``quant_dtype`` ('none' | 'bf16' | 'int8') makes
    ``build`` and ``updates.insert`` keep quantized blocks for
    ``search_batch_fixed(dtype=...)``.
    """

    n: int
    d: int
    c: float = 1.5
    w0: float = 4.0 * 1.5 * 1.5  # 4 c^2, i.e. gamma = 2
    t: int = 100
    k: int = 50
    K: int = 0  # 0 -> derive
    L: int = 0  # 0 -> derive
    block_size: int = 64          # B: points per STR block
    max_blocks: int = 0           # M: blocks fetched per table; 0 -> derive
    max_radius_steps: int = 24    # safety bound on the r = c^j schedule
    inline_vectors: bool = False  # 'inline' layout: per-table vector copy
    use_kernel: bool = False
    quant_dtype: str = "none"

    # --- derived (filled by .resolve()) ---
    p1: float = 0.0
    p2: float = 0.0
    rho: float = 0.0

    @staticmethod
    def derive(
        n: int,
        d: int,
        c: float = 1.5,
        w0: float | None = None,
        t: int = 100,
        k: int = 50,
        K: int = 0,
        L: int = 0,
        **kw,
    ) -> "DBLSHParams":
        if w0 is None:
            w0 = 4.0 * c * c
        p1 = _p(1.0, w0)
        p2 = _p(c, w0)
        rho = rho_star(c, w0)
        nt = max(n / max(t, 1), 2.0)
        if K <= 0:
            K = max(2, math.ceil(math.log(nt) / _log_inv_p(c, w0)))
        if L <= 0:
            L = max(1, math.ceil(nt**rho))
        params = DBLSHParams(
            n=n, d=d, c=c, w0=w0, t=t, k=k, K=K, L=L, p1=p1, p2=p2, rho=rho, **kw
        )
        return params.resolve()

    def resolve(self) -> "DBLSHParams":
        """Fill derived fields; idempotent."""
        if self.quant_dtype not in ("none", "bf16", "int8"):
            raise ValueError(
                f"quant_dtype must be 'none', 'bf16' or 'int8', "
                f"got {self.quant_dtype!r}"
            )
        upd: dict = {}
        if self.p1 == 0.0:
            upd["p1"] = _p(1.0, self.w0)
            upd["p2"] = _p(self.c, self.w0)
            upd["rho"] = rho_star(self.c, self.w0)
        if self.max_blocks <= 0:
            # per table verify >= 2t + k points, x2 slack because an
            # overlapping block is only partially in-box
            per_table = 2 * self.t + self.k
            m = max(4, math.ceil(2.0 * per_table / self.block_size))
            upd["max_blocks"] = min(m, max(1, math.ceil(self.n / self.block_size)))
        if not upd:
            return self
        return dataclasses.replace(self, **upd)

    @property
    def cand_per_table(self) -> int:
        return self.max_blocks * self.block_size

    @property
    def budget(self) -> int:
        """The paper's termination budget 2tL + k."""
        return 2 * self.t * self.L + self.k

    def alpha(self) -> float:
        """alpha implied by w0 = 2 gamma c^2 (Lemma 3)."""
        gamma = self.w0 / (2.0 * self.c * self.c)
        return alpha_of_gamma(gamma)
