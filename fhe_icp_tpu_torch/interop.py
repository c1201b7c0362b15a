"""Carry keys and ciphertexts between the JAX package and the port.

Both sides exchange plain numpy arrays, so this module imports neither
JAX nor the JAX package.  Keys use the JAX key-file layout: `s`,
`s_ntt_mont`, `s2_ntt_mont`, `pk_b`, `pk_a` and one `rlk_<level>` array
per relinearization level.  Ciphertexts are (..., k, L, N) uint32 with
their `level` and `pt_corr`.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from .ops.cipher import Ciphertext, KeySet, PublicKey, SecretKey
from .ops.context import CryptoContext


def _tensor(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=dtype, order="C", copy=True)).to(device)


def keys_from_arrays(ctx: CryptoContext, arrays: Mapping[str, np.ndarray],
                     device: Optional[torch.device | str] = None) -> KeySet:
    """A port KeySet from the arrays of a JAX key set (on ctx's device by default)."""
    dev = ctx.device if device is None else torch.device(device)
    n, l = ctx.n, ctx.n_limbs
    shapes = {"s": (n,), "s_ntt_mont": (l, n), "s2_ntt_mont": (l, n),
              "pk_b": (l, n), "pk_a": (l, n)}
    for name, shape in shapes.items():
        if np.shape(arrays[name]) != shape:
            raise ValueError(f"key array {name} has shape {np.shape(arrays[name])}, "
                             f"expected {shape} for {ctx.params.name}")
    u32 = np.uint32
    sk = SecretKey(s=_tensor(arrays["s"], np.int32, dev),
                   s_ntt_mont=_tensor(arrays["s_ntt_mont"], u32, dev),
                   s2_ntt_mont=_tensor(arrays["s2_ntt_mont"], u32, dev))
    pk = PublicKey(b_ntt=_tensor(arrays["pk_b"], u32, dev),
                   a_ntt=_tensor(arrays["pk_a"], u32, dev))
    rlk = {int(k.split("_", 1)[1]): _tensor(v, u32, dev)
           for k, v in arrays.items() if k.startswith("rlk_")}
    return KeySet(sk=sk, pk=pk, rlk=rlk)


def keys_to_arrays(keys: KeySet) -> Dict[str, np.ndarray]:
    """The JAX key-file arrays of a port KeySet."""
    out = {"s": keys.sk.s.cpu().numpy(),
           "s_ntt_mont": keys.sk.s_ntt_mont.cpu().numpy(),
           "s2_ntt_mont": keys.sk.s2_ntt_mont.cpu().numpy(),
           "pk_b": keys.pk.b_ntt.cpu().numpy(),
           "pk_a": keys.pk.a_ntt.cpu().numpy()}
    out.update({f"rlk_{lv}": rk.cpu().numpy() for lv, rk in keys.rlk.items()})
    return out


def ciphertext_from_array(data: np.ndarray, level: int, pt_corr: int = 1,
                          device: torch.device | str = "cpu") -> Ciphertext:
    """A port Ciphertext from (..., k, L, N) uint32 NTT-domain data."""
    if np.ndim(data) < 3 or np.shape(data)[-2] != level:
        raise ValueError(f"ciphertext data {np.shape(data)} does not hold "
                         f"{level} limbs on axis -2")
    return Ciphertext(_tensor(data, np.uint32, device), level=level, is_ntt=True,
                      pt_corr=int(pt_corr))


def ciphertext_to_array(ct: Ciphertext) -> Tuple[np.ndarray, int, int]:
    """(data, level, pt_corr) of a port Ciphertext, data as numpy uint32."""
    return ct.data.cpu().numpy(), ct.level, ct.pt_corr
