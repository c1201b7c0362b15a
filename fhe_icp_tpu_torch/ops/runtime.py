"""FheRuntime: the port's entry points, bound to one parameter set and key set.

The runtime lives on one device, the card unless the caller asks for
another: `FheRuntime(params)` needs CUDA and raises without it; tests
pass `device="cpu"`, where every kernel wrapper runs its plain version.

Encryption randomness must never repeat across messages (c0 - c0' =
m - m' would leak the difference).  Every `seed=None` draw therefore
advances one long-lived generator per device, seeded once from
`os.urandom`: no draw within a process repeats another (the CPU's
mt19937 keeps only 32 bits of a seed, so seeding a new generator per call
would repeat after about 77,000 encryptions).  Pass an integer seed only
for deterministic tests.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional, Sequence

import torch

from ..devices import target
from . import arith, dot, galois
from .cipher import Ciphertext, KeySet, decrypt, encrypt_pk, encrypt_sym, keygen
from .context import CryptoContext
from .encoding import encode_fwd, encode_rev
from .params import CryptoParams, get_params


def fresh_seed() -> int:
    """A 63-bit seed from OS entropy."""
    return int.from_bytes(os.urandom(8), "little") >> 1


_fresh_generators: Dict[torch.device, torch.Generator] = {}
_fresh_lock = threading.Lock()


def fresh_generator(device: torch.device) -> torch.Generator:
    """The device's process-wide generator for fresh randomness, seeded once
    from `fresh_seed()`; every draw from it advances it."""
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with _fresh_lock:
        gen = _fresh_generators.get(device)
        if gen is None:
            gen = _fresh_generators[device] = torch.Generator(device=device)
            gen.manual_seed(fresh_seed())
        return gen


class FheRuntime:
    """FHE operations bound to one parameter set, key set and device."""

    def __init__(self, params: CryptoParams | str, keys: Optional[KeySet] = None,
                 rlk_levels: Optional[Sequence[int]] = None,
                 device: torch.device | str = "cuda"):
        """`rlk_levels` restricts relinearization-key generation to the listed
        levels (default: every level >= 2; [] for ct x pt work only)."""
        device = target(device, "FheRuntime")
        if isinstance(params, str):
            params = get_params(params)
        self.params = params
        self.device = device
        self.ctx = CryptoContext(params, device)
        self.keys = keys
        self._rlk_levels = rlk_levels
        self._gkeys: Optional[galois.GaloisKeys] = None

    def generator(self, seed: Optional[int]) -> torch.Generator:
        """A new generator seeded with `seed` on the runtime's device, or for
        seed=None the device's process-wide fresh generator."""
        if seed is None:
            return fresh_generator(self.device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        return gen

    # -- keys --------------------------------------------------------------
    def generate_keys(self, seed: Optional[int] = 0) -> KeySet:
        """Secret, public and relinearization keys (at `rlk_levels`)."""
        self.keys = keygen(self.ctx, self.generator(seed), rlk_levels=self._rlk_levels)
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

    def encrypt_public(self, m, seed: Optional[int] = None) -> Ciphertext:
        """Public-key encryption of the message poly (..., N)."""
        return encrypt_pk(self.ctx, self._require_keys().pk, self.generator(seed),
                          self._int32(m))

    def decrypt(self, ct: Ciphertext) -> torch.Tensor:
        return decrypt(self.ctx, self._require_keys().sk, ct)

    def add(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        return arith.add(self.ctx, a, b)

    def sub(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        return arith.sub(self.ctx, a, b)

    def neg(self, a: Ciphertext) -> Ciphertext:
        return arith.neg(self.ctx, a)

    def mul_ct(self, a: Ciphertext, b: Ciphertext, relinearize: bool = True) -> Ciphertext:
        prod = arith.mul_ct(self.ctx, a, b)
        if relinearize:
            prod = arith.relinearize(self.ctx, self._require_keys().rlk, prod)
        return prod

    def mod_switch(self, ct: Ciphertext) -> Ciphertext:
        return arith.mod_switch(self.ctx, ct)

    # -- vector / dot-product API -----------------------------------------
    def encrypt_vector(self, vec, seed: Optional[int] = None,
                       rev: bool = False) -> Ciphertext:
        """Encrypt (..., d) vectors in the ascending (or reversed) encoding."""
        enc = encode_rev if rev else encode_fwd
        return self.encrypt(enc(self._int32(vec), self.ctx.n), seed=seed)

    def dot_ct_pt(self, ct: Ciphertext, vec_clear) -> Ciphertext:
        return dot.dot_ct_pt(self.ctx, ct, self._int32(vec_clear))

    def dot_ct_ct(self, ct_a: Ciphertext, ct_b_rev: Ciphertext,
                  relinearize: bool = True) -> Ciphertext:
        """Encrypted dot product.  relinearize=False returns the degree-2
        product, which decrypts to the same score without the keyswitch."""
        if not relinearize:
            return dot.dot_ct_ct_deg2(self.ctx, ct_a, ct_b_rev)
        return dot.dot_ct_ct(self.ctx, self._require_keys().rlk, ct_a, ct_b_rev)

    def matvec(self, cts: Ciphertext, query_clear) -> Ciphertext:
        return dot.matvec_ct_pt(self.ctx, cts, self._int32(query_clear))

    def decrypt_dot(self, ct: Ciphertext, d: int) -> torch.Tensor:
        return dot.decrypt_dot(self.ctx, self._require_keys().sk, ct, d)

    # -- Galois rotations / SIMD slots (ops/galois.py) ----------------------
    def rotation_keys(self, seed: Optional[int] = None, levels=None,
                      digit_bits: int = 16) -> galois.GaloisKeys:
        """Generate (once, then cached) the rotation and row-flip Galois keys.

        digit_bits=16 (default) gives fine-digit keys, which keep the
        rotate-and-sum chain decryptable at the 2-limb presets; 0 halves
        their cost for presets with room.
        """
        if self._gkeys is None:
            self._gkeys = galois.rotation_keygen(self.ctx, self._require_keys().sk,
                                                 self.generator(seed), levels=levels,
                                                 digit_bits=digit_bits)
        return self._gkeys

    def _gkeys_for_level(self, level: int) -> galois.GaloisKeys:
        """Rotation keys that cover `level`, generating the missing level's
        keys (from fresh OS entropy) on first use."""
        gk = self.rotation_keys()
        if not any(lv == level for (_, lv) in gk.keys):
            extra = galois.rotation_keygen(self.ctx, self._require_keys().sk,
                                           self.generator(None), levels=[level])
            gk.keys.update(extra.keys)
        return gk

    def encrypt_slots(self, vals, seed: Optional[int] = None) -> Ciphertext:
        """Encrypt (..., 2, N/2) int32 SIMD slot values."""
        return self.encrypt(galois.encode_slots(self.ctx, self._int32(vals)), seed=seed)

    def decrypt_slots(self, ct: Ciphertext) -> torch.Tensor:
        return galois.decode_slots(self.ctx, self.decrypt(ct))

    def rotate_slots(self, ct: Ciphertext, k: int) -> Ciphertext:
        return galois.rotate_slots(self.ctx, self._gkeys_for_level(ct.level), ct, k)

    def dot_ct_ct_slots(self, ct_a: Ciphertext, ct_b: Ciphertext,
                        d: Optional[int] = None) -> Ciphertext:
        """Fully encrypted slotwise inner product (rotate-and-sum); with a
        power-of-two `d` (operands in slots 0..d-1 of row 0) only log2(d)
        prefix rotations run and the score sits in slot [0, 0]."""
        return galois.dot_ct_ct_slots(self.ctx, self._require_keys().rlk,
                                      self._gkeys_for_level(ct_a.level), ct_a, ct_b, d=d)
