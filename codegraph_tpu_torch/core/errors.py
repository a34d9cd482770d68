"""Copy of `codegraph_tpu/core/errors.py` for the PyTorch port.

Framework error types (reference: codegraph-vector/src/error.rs)."""


class CodeGraphError(Exception):
    """Base error."""


class DimensionMismatch(CodeGraphError):
    def __init__(self, expected: int, got: int):
        super().__init__(f"embedding dimension mismatch: expected {expected}, got {got}")
        self.expected = expected
        self.got = got


class IndexNotBuilt(CodeGraphError):
    pass


class SnapshotError(CodeGraphError):
    pass


class ProviderUnavailable(CodeGraphError):
    pass


__all__ = [
    "CodeGraphError",
    "DimensionMismatch",
    "IndexNotBuilt",
    "SnapshotError",
    "ProviderUnavailable",
]
