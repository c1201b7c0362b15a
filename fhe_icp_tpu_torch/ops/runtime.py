"""FheRuntime: the port's entry points, bound to one parameter set and key set.

The runtime lives on one device, the card unless the caller asks for
another: `FheRuntime(params)` needs CUDA and raises without it; tests
pass `device="cpu"`, where every kernel wrapper runs its plain version.

Encryption randomness must never repeat across messages (c0 - c0' =
m - m' would leak the difference), so every encrypt entry point defaults
to a generator seeded from `os.urandom`.  Pass an integer seed only for
deterministic tests.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from ..devices import target
from . import arith
from .cipher import Ciphertext, KeySet, decrypt, encrypt_sym, keygen
from .context import CryptoContext
from .encoding import encode_fwd, encode_rev
from .params import CryptoParams, get_params


def fresh_seed() -> int:
    """A 63-bit seed from OS entropy."""
    return int.from_bytes(os.urandom(8), "little") >> 1


class FheRuntime:
    """FHE operations bound to one parameter set, key set and device."""

    def __init__(self, params: CryptoParams | str, keys: Optional[KeySet] = None,
                 device: torch.device | str = "cuda"):
        device = target(device, "FheRuntime")
        if isinstance(params, str):
            params = get_params(params)
        self.params = params
        self.device = device
        self.ctx = CryptoContext(params, device)
        self.keys = keys

    def generator(self, seed: Optional[int]) -> torch.Generator:
        """A generator on the runtime's device; seed=None draws OS entropy."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(fresh_seed() if seed is None else int(seed))
        return gen

    # -- keys --------------------------------------------------------------
    def generate_keys(self, seed: Optional[int] = 0) -> KeySet:
        """Secret and public keys (no relinearization keys yet)."""
        self.keys = keygen(self.ctx, self.generator(seed))
        return self.keys

    def _require_keys(self) -> KeySet:
        if self.keys is None:
            raise RuntimeError("no keys loaded; call generate_keys() first")
        return self.keys

    def _int32(self, m) -> torch.Tensor:
        return torch.as_tensor(m, dtype=torch.int32, device=self.device)

    # -- core ops ----------------------------------------------------------
    def encrypt(self, m, seed: Optional[int] = None) -> Ciphertext:
        """Encrypt the message poly (..., N) with fresh randomness by default."""
        return encrypt_sym(self.ctx, self._require_keys().sk, self.generator(seed),
                           self._int32(m))

    def encrypt_vector(self, vec, seed: Optional[int] = None,
                       rev: bool = False) -> Ciphertext:
        """Encrypt (..., d) vectors in the ascending (or reversed) encoding."""
        enc = encode_rev if rev else encode_fwd
        return self.encrypt(enc(self._int32(vec), self.ctx.n), seed=seed)

    def decrypt(self, ct: Ciphertext) -> torch.Tensor:
        return decrypt(self.ctx, self._require_keys().sk, ct)

    def mod_switch(self, ct: Ciphertext) -> Ciphertext:
        return arith.mod_switch(self.ctx, ct)
