"""CryptoContext: every precomputed table the BGV functions need.

Built once, host-side, with exact Python big-int arithmetic; every table
is a uint32 tensor on the context's device, with the values of the JAX
package's `ops/context.py`.

Exact RNS decode: given residues x_j of x in [0, q),

    y_j = [x_j * (q/p_j)^{-1}]_{p_j}
    centered(x) = sum_j y_j*(q/p_j) - round(sum_j y_j/p_j) * q

The sum of y_j/p_j is accumulated in Q56 fixed point (y_j * floor(2^56/p_j));
the mod-t value is then assembled from (q/p_j mod t) and (q mod t).  Level
l uses primes[0:l], dropping limbs from the end.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..devices import target
from . import primes as pr
from .ntt import NttPlan, build_plan
from .params import CryptoParams


@dataclass(frozen=True)
class HybridTables:
    """Hybrid-keyswitch tables for one level: primes[0:l] + special P.

    The keyswitch key lives over the extended chain (l+1 limbs, special
    prime last); after digit accumulation the result is divided by P with
    the rounding of modulus switching.  The key encrypts P * target, so the
    division leaves the message term intact.
    """

    l: int
    plan: NttPlan                 # NTT plan over primes[0:l] + (P,)
    p: torch.Tensor               # (l+1, 1) extended prime column
    pinv: torch.Tensor            # (l+1, 1) Montgomery -p^{-1}
    r2: torch.Tensor              # (l+1, 1) R^2 mod p
    mu: torch.Tensor              # (l+1, 1) Barrett mu
    t_mont: torch.Tensor          # (l+1, 1) t*R mod p (payload scaling)
    # --- divide-by-P (drop the special limb) ---
    t_inv_mont_sp: torch.Tensor   # (1,1) [t^{-1}]_P, mont-of-P
    sp_half: torch.Tensor         # (1,1) P // 2
    sp_mod_pi: torch.Tensor       # (l,1) P mod p_i
    inv_sp_mont: torch.Tensor     # (l,1) [P^{-1}]_{p_i}, mont-of-p_i
    t_inv_sp_mont: torch.Tensor   # (l,1) [t*P^{-1}]_{p_i}, mont-of-p_i


@dataclass(frozen=True)
class LevelTables:
    """Decode + modswitch tables for one level (active primes[0:l])."""

    l: int
    # --- exact centered mod-t decode ---
    inv_qhat: torch.Tensor        # (l,1) [(q/p_j)^{-1}]_{p_j}
    inv_qhat_sh: torch.Tensor     # (l,1) Shoup companion
    r_t_mont: torch.Tensor        # (l,1) (q/p_j mod t) in Montgomery-of-t form
    q_mod_t_mont: torch.Tensor    # (1,1) (q mod t) in Montgomery-of-t form
    # --- modswitch: drop prime p_d = primes[l-1], go to level l-1 ---
    # (absent at level 1)
    t_inv_mont_pd: Optional[torch.Tensor]    # (1,1) [t^{-1}]_{p_d}, mont-of-p_d
    pd_half: Optional[torch.Tensor]          # (1,1) p_d // 2
    pd_mod_pi: Optional[torch.Tensor]        # (l-1,1) p_d mod p_i
    inv_pd_mont: Optional[torch.Tensor]      # (l-1,1) [p_d^{-1}]_{p_i}, mont-of-p_i


class CryptoContext:
    """All device tables for one CryptoParams preset, on one device.

    The device is the card unless the caller asks for another; without
    CUDA the default raises.
    """

    def __init__(self, params: CryptoParams, device: torch.device | str = "cuda"):
        self.params = params
        self.device = target(device, "CryptoContext")
        self.cache: Dict = {}          # derived tables (see cipher.py, pack.py)
        self.n = params.n
        self.t = params.t
        self.n_limbs = params.n_limbs
        prime_list = params.primes
        self.primes: Tuple[int, ...] = prime_list
        self.plan: NttPlan = build_plan(self.n, prime_list, self.device)

        col = self.col
        # Per-limb Montgomery / Barrett constants, shape (L, 1).
        mc = [pr.mont_constants(p) for p in prime_list]
        self.p = col(prime_list)
        self.p_neg_inv = col([c["p_neg_inv"] for c in mc])
        self.r2 = col([c["r2_mod_p"] for c in mc])
        self.mu_p = col([pr.barrett_mu(p) for p in prime_list])
        t = params.t
        self.t_mont_p = col([t * (1 << 32) % p for p in prime_list])
        # v-estimation constants floor(2^56 / p_j) — level independent.
        self.v_c = col([(1 << 56) // p for p in prime_list])

        # Plaintext-modulus constants (stored (1,1) for broadcast).
        tc = pr.mont_constants(t)
        self.t_u32 = col([t])
        self.t_neg_inv = col([tc["p_neg_inv"]])
        self.r2_t = col([tc["r2_mod_p"]])
        self.mu_t = col([pr.barrett_mu(t)])
        self.t_half = col([t // 2])

        self.levels: Dict[int, LevelTables] = {}
        for l in range(1, self.n_limbs + 1):
            active = prime_list[:l]
            q = self.q_at(l)
            inv_qhat, r_t = [], []
            for p in active:
                qhat = q // p
                inv = pow(qhat % p, -1, p)
                inv_qhat.append(inv)
                r_t.append((qhat % t) * (1 << 32) % t)   # mont-of-t form
            if l >= 2:
                pd = active[-1]
                rest = active[:-1]
                t_inv_mont_pd = col([pow(t, -1, pd) * (1 << 32) % pd])
                pd_half = col([pd // 2])
                pd_mod_pi = col([pd % p for p in rest])
                inv_pd_mont = col([pow(pd, -1, p) * (1 << 32) % p for p in rest])
            else:
                t_inv_mont_pd = pd_half = pd_mod_pi = inv_pd_mont = None
            self.levels[l] = LevelTables(
                l=l,
                inv_qhat=col(inv_qhat),
                inv_qhat_sh=col([pr.shoup(v, p) for v, p in zip(inv_qhat, active)]),
                r_t_mont=col(r_t),
                q_mod_t_mont=col([(q % t) * (1 << 32) % t]),
                t_inv_mont_pd=t_inv_mont_pd,
                pd_half=pd_half,
                pd_mod_pi=pd_mod_pi,
                inv_pd_mont=inv_pd_mont,
            )

    def col(self, vals) -> torch.Tensor:
        """(l, 1) uint32 column on the context's device."""
        return self.tensor(np.asarray(vals, dtype=np.uint32)[:, None])

    def tensor(self, a: np.ndarray) -> torch.Tensor:
        """A host numpy table as a tensor on the context's device."""
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def cached(self, key, build):
        """ctx.cache[key], built by `build()` on first use."""
        out = self.cache.get(key)
        if out is None:
            out = self.cache[key] = build()
        return out

    # -- hybrid keyswitch tables (built on first use, per level) -------------
    def hybrid(self, l: int) -> HybridTables:
        """Tables for hybrid keyswitching at level l (primes[0:l] + P)."""
        if not 2 <= l <= self.n_limbs:
            raise ValueError(f"hybrid keyswitching needs a level in 2..{self.n_limbs}, got {l}")
        return self.cached(("hybrid", l), lambda: self._build_hybrid(l))

    def _build_hybrid(self, l: int) -> HybridTables:
        sp = self.params.special_prime
        chain = self.primes[:l]
        ext = tuple(chain) + (sp,)
        mc = [pr.mont_constants(p) for p in ext]
        t, col = self.t, self.col
        return HybridTables(
            l=l,
            plan=build_plan(self.n, ext, self.device),
            p=col(ext),
            pinv=col([c["p_neg_inv"] for c in mc]),
            r2=col([c["r2_mod_p"] for c in mc]),
            mu=col([pr.barrett_mu(p) for p in ext]),
            t_mont=col([t * (1 << 32) % p for p in ext]),
            t_inv_mont_sp=col([pow(t, -1, sp) * (1 << 32) % sp]),
            sp_half=col([sp // 2]),
            sp_mod_pi=col([sp % p for p in chain]),
            inv_sp_mont=col([pow(sp, -1, p) * (1 << 32) % p for p in chain]),
            t_inv_sp_mont=col([t * pow(sp, -1, p) % p * (1 << 32) % p for p in chain]),
        )

    # -- convenience slices for a given level ------------------------------
    def lp(self, l: int) -> torch.Tensor:
        return self.p[:l]

    def lpinv(self, l: int) -> torch.Tensor:
        return self.p_neg_inv[:l]

    def lr2(self, l: int) -> torch.Tensor:
        return self.r2[:l]

    def q_at(self, l: int) -> int:
        q = 1
        for p in self.primes[:l]:
            q *= p
        return q

    def __repr__(self):
        return (f"CryptoContext({self.params.name}: N={self.n}, "
                f"L={self.n_limbs}, log q={self.params.log_q}, t={self.t}, "
                f"device={self.device})")
