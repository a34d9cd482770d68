"""Copy of `codegraph_tpu/core/secrets.py` for the PyTorch port.

Encrypted secret storage for API keys.

Reference: crates/codegraph-core/src/config.rs crypto module —
chacha20poly1305-encrypted secrets in the config dir. Same construction:
ChaCha20-Poly1305 AEAD with a machine-local key file (0600) generated on
first use; secrets persist as nonce||ciphertext blobs in a JSON map.
Environment variables always take precedence (12-factor style) — the
store is the fallback for long-lived local setups.
"""

from __future__ import annotations

import base64
import json
import os
from pathlib import Path
from typing import Dict, Optional

from cryptography.hazmat.primitives.ciphers.aead import ChaCha20Poly1305

KEY_FILE = "secret.key"
SECRETS_FILE = "secrets.json"


class SecretStore:
    def __init__(self, config_dir: Optional[str] = None):
        from codegraph_tpu_torch.core.config import CONFIG_DIR

        self.dir = Path(config_dir) if config_dir else CONFIG_DIR
        self._key: Optional[bytes] = None

    # -- key management ------------------------------------------------------

    def _key_path(self) -> Path:
        return self.dir / KEY_FILE

    def _load_key(self) -> bytes:
        if self._key is not None:
            return self._key
        path = self._key_path()
        if path.exists():
            self._key = base64.b64decode(path.read_bytes())
        else:
            self.dir.mkdir(parents=True, exist_ok=True)
            self._key = ChaCha20Poly1305.generate_key()
            path.write_bytes(base64.b64encode(self._key))
            os.chmod(path, 0o600)
        return self._key

    # -- secret map ------------------------------------------------------------

    def _secrets_path(self) -> Path:
        return self.dir / SECRETS_FILE

    def _read_map(self) -> Dict[str, str]:
        path = self._secrets_path()
        if not path.exists():
            return {}
        try:
            return json.loads(path.read_text())
        except ValueError:
            return {}

    def set(self, name: str, value: str) -> None:
        key = self._load_key()
        aead = ChaCha20Poly1305(key)
        nonce = os.urandom(12)
        blob = nonce + aead.encrypt(nonce, value.encode(), name.encode())
        data = self._read_map()
        data[name] = base64.b64encode(blob).decode()
        self.dir.mkdir(parents=True, exist_ok=True)
        self._secrets_path().write_text(json.dumps(data))
        os.chmod(self._secrets_path(), 0o600)

    def get(self, name: str) -> Optional[str]:
        """Env var wins; falls back to the encrypted store."""
        env = os.environ.get(name)
        if env:
            return env
        data = self._read_map()
        blob_b64 = data.get(name)
        if not blob_b64:
            return None
        blob = base64.b64decode(blob_b64)
        aead = ChaCha20Poly1305(self._load_key())
        try:
            return aead.decrypt(blob[:12], blob[12:], name.encode()).decode()
        except Exception:
            return None  # wrong key / tampered blob

    def delete(self, name: str) -> None:
        data = self._read_map()
        if name in data:
            del data[name]
            self._secrets_path().write_text(json.dumps(data))

    def names(self):
        return sorted(self._read_map())


__all__ = ["SecretStore"]
