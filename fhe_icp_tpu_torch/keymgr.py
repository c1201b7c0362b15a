"""FHEKeyManager: RLWE key material, encrypted at rest.

Key generation produces the secret, public and relinearization keys of a
preset on the manager's device.  The secret key file is encrypted with a
Fernet key derived from the master password (PBKDF2-HMAC-SHA256, 100,000
iterations, 16-byte salt); public material is stored unencrypted.  File
modes 0600, a metadata JSON with a current-key pointer, rotation with a
grace period, and re-key files (keyswitch keys old -> new, public
material) for migrating a store without decrypting it.

The key directory's layout is the JAX package's, down to the verify
token's plaintext, so one key directory serves both packages:
`salt.bin`, `verify.token`, `metadata.json`, `<id>.sk.enc` (arrays `s`,
`s_ntt_mont`, `s2_ntt_mont`), `<id>.pub` (`pk_b`, `pk_a`, `rlk_<level>`)
and `rekey_<old>__to__<new>.npz` (`ksk_<level>`).  Keys live on the
device as tensors; only the file boundary converts them to numpy
(`interop`).
"""

from __future__ import annotations

import base64
import getpass
import io
import json
import logging
import os
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch
from cryptography.fernet import Fernet, InvalidToken
from cryptography.hazmat.primitives import hashes
from cryptography.hazmat.primitives.kdf.pbkdf2 import PBKDF2HMAC

from . import interop
from .devices import target
from .ops.cipher import rekey_keygen
from .ops.runtime import FheRuntime

logger = logging.getLogger(__name__)

_KDF_ITERATIONS = 100_000
_VERIFY_PLAINTEXT = b"fhe-icp-tpu-verify"
_SECRET_ARRAYS = ("s", "s_ntt_mont", "s2_ntt_mont")


def derive_fernet_key(password: str, salt: bytes) -> bytes:
    kdf = PBKDF2HMAC(algorithm=hashes.SHA256(), length=32, salt=salt,
                     iterations=_KDF_ITERATIONS)
    return base64.urlsafe_b64encode(kdf.derive(password.encode()))


def _npz_bytes(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    return buf.getvalue()


def _npz_load(raw: bytes) -> Dict[str, np.ndarray]:
    return dict(np.load(io.BytesIO(raw), allow_pickle=False))


class FHEKeyManager:
    def __init__(self, key_dir: str = "~/.fhe_keys",
                 preset: str = "pairwise-4096",
                 device: torch.device | str = "cuda"):
        self.device = target(device, "FHEKeyManager")
        self.key_dir = Path(key_dir).expanduser()
        self.key_dir.mkdir(parents=True, exist_ok=True, mode=0o700)
        self.preset = preset
        self.meta_path = self.key_dir / "metadata.json"
        self._fernet: Optional[Fernet] = None

    # -- master password ---------------------------------------------------
    def _get_master_key(self) -> Fernet:
        """Derive (and verify) the Fernet key from the master password.

        Password sources, in order: the FHE_MASTER_PASSWORD environment
        variable, then an interactive prompt.  A stored verify token checks
        the password and raises ValueError on a mismatch.
        """
        if self._fernet is not None:
            return self._fernet
        password = os.environ.get("FHE_MASTER_PASSWORD")
        if password is None:
            password = getpass.getpass("Master password: ")
        salt_path = self.key_dir / "salt.bin"
        token_path = self.key_dir / "verify.token"
        if not salt_path.exists():
            salt = os.urandom(16)
            salt_path.write_bytes(salt)
            os.chmod(salt_path, 0o600)
            f = Fernet(derive_fernet_key(password, salt))
            token_path.write_bytes(f.encrypt(_VERIFY_PLAINTEXT))
            os.chmod(token_path, 0o600)
        else:
            salt = salt_path.read_bytes()
            f = Fernet(derive_fernet_key(password, salt))
            try:
                if f.decrypt(token_path.read_bytes()) != _VERIFY_PLAINTEXT:
                    raise ValueError("master password verification failed")
            except InvalidToken:
                raise ValueError("incorrect master password")
        self._fernet = f
        return f

    # -- metadata ----------------------------------------------------------
    def _load_meta(self) -> Dict:
        if self.meta_path.exists():
            return json.loads(self.meta_path.read_text())
        return {"keys": {}, "current": None}

    def _save_meta(self, meta: Dict) -> None:
        self.meta_path.write_text(json.dumps(meta, indent=2))
        os.chmod(self.meta_path, 0o600)

    # -- key generation ----------------------------------------------------
    def generate_keys(self, key_id: Optional[str] = None,
                      seed: Optional[int] = None) -> str:
        t0 = time.time()
        key_id = key_id or f"fhe_key_{int(time.time())}"
        seed = seed if seed is not None else int.from_bytes(os.urandom(4), "little")
        f = self._get_master_key()

        rt = FheRuntime(self.preset, device=self.device)
        arrays = interop.keys_to_arrays(rt.generate_keys(seed=seed))

        sk_path = self.key_dir / f"{key_id}.sk.enc"
        sk_path.write_bytes(f.encrypt(_npz_bytes(**{k: arrays.pop(k) for k in _SECRET_ARRAYS})))
        os.chmod(sk_path, 0o600)

        pub_path = self.key_dir / f"{key_id}.pub"
        pub_path.write_bytes(_npz_bytes(**arrays))
        os.chmod(pub_path, 0o600)

        meta = self._load_meta()
        meta["keys"][key_id] = {
            "created_at": time.time(),
            "preset": self.preset,
            "seed_fingerprint": hex(hash(seed) & 0xFFFFFFFF),
            "status": "active",
            "generation_time_s": time.time() - t0,
        }
        meta["current"] = key_id
        self._save_meta(meta)
        logger.info("generated key %s in %.2fs", key_id, time.time() - t0)
        return key_id

    # -- key access --------------------------------------------------------
    def list_keys(self) -> List[str]:
        return sorted(self._load_meta()["keys"])

    def get_current_key(self) -> Optional[str]:
        return self._load_meta()["current"]

    def key_info(self, key_id: str) -> Dict:
        """Metadata for one key, with the size of its files on disk."""
        info = dict(self._load_meta()["keys"][key_id])
        size = 0
        for path in (self.key_dir / f"{key_id}.sk.enc",
                     self.key_dir / f"{key_id}.pub"):
            if path.exists():
                size += path.stat().st_size
        info["size_bytes"] = size
        return info

    def load_keyset(self, key_id: Optional[str] = None,
                    runtime: Optional[FheRuntime] = None) -> FheRuntime:
        """Load keys into a runtime on the manager's device (decrypting the
        secret key at rest)."""
        key_id = key_id or self.get_current_key()
        if key_id is None:
            raise RuntimeError("no keys generated yet")
        meta = self._load_meta()["keys"].get(key_id)
        if meta is None:
            raise KeyError(f"unknown key {key_id!r}")
        f = self._get_master_key()
        arrays = _npz_load(f.decrypt((self.key_dir / f"{key_id}.sk.enc").read_bytes()))
        arrays.update(_npz_load((self.key_dir / f"{key_id}.pub").read_bytes()))
        rt = runtime or FheRuntime(meta.get("preset", self.preset), device=self.device)
        rt.keys = interop.keys_from_arrays(rt.ctx, arrays)
        return rt

    # -- homomorphic re-keying (old key -> new key, no decryption) ----------
    def _rekey_path(self, old_key_id: str, new_key_id: str) -> Path:
        return self.key_dir / f"rekey_{old_key_id}__to__{new_key_id}.npz"

    def make_rekey_key(self, old_key_id: str,
                       new_key_id: Optional[str] = None) -> Path:
        """Generate + persist keyswitch keys old -> new (public material).

        Requires the master password (both secret keys are decrypted to
        build the keys), but the resulting file is public-key material,
        stored unencrypted like `.pub`; `batch.rekey_documents` migrates a
        store with it.
        """
        new_key_id = new_key_id or self.get_current_key()
        if new_key_id is None:
            raise RuntimeError("no current key to rekey to")
        old_rt = self.load_keyset(old_key_id)
        new_rt = self.load_keyset(new_key_id)
        ksks = rekey_keygen(new_rt.ctx, new_rt.generator(None), old_rt.keys.sk,
                            new_rt.keys.sk)
        path = self._rekey_path(old_key_id, new_key_id)
        path.write_bytes(_npz_bytes(**interop.rekey_keys_to_arrays(ksks)))
        os.chmod(path, 0o600)
        logger.info("rekey key %s -> %s written", old_key_id, new_key_id)
        return path

    def load_rekey_key(self, old_key_id: str,
                       new_key_id: Optional[str] = None) -> Dict[int, torch.Tensor]:
        """{level: keyswitch key} for old -> new on the manager's device,
        generating the file if absent."""
        new_key_id = new_key_id or self.get_current_key()
        path = self._rekey_path(old_key_id, new_key_id)
        if not path.exists():
            self.make_rekey_key(old_key_id, new_key_id)
        return interop.rekey_keys_from_arrays(_npz_load(path.read_bytes()),
                                              device=self.device)

    # -- rotation ----------------------------------------------------------
    def rotate_keys(self, grace_period_days: int = 7) -> str:
        meta = self._load_meta()
        old = meta.get("current")
        new_id = self.generate_keys()
        if old and old in self._load_meta()["keys"]:
            meta = self._load_meta()
            meta["keys"][old]["status"] = "rotated"
            meta["keys"][old]["rotated_at"] = time.time()
            meta["keys"][old]["grace_until"] = time.time() + grace_period_days * 86400
            self._save_meta(meta)
        return new_id

    def get_stats(self) -> Dict:
        meta = self._load_meta()
        return {
            "key_count": len(meta["keys"]),
            "current_key": meta["current"],
            "key_dir": str(self.key_dir),
            "preset": self.preset,
        }
