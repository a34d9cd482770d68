"""Copy of `codegraph_tpu/mcp/process.py` for the PyTorch port.

PID-file process management for the daemon.

Reference: codegraph-mcp-core/src/process.rs (373 LoC) and
codegraph-mcp-daemon/src/daemon/pid.rs — write/read/clear PID files,
liveness probe via signal 0.
"""

from __future__ import annotations

import os
from typing import Optional

PID_FILE = "daemon.pid"


def pid_path(data_dir: str) -> str:
    return os.path.join(data_dir, PID_FILE)


def write_pid(data_dir: str, pid: Optional[int] = None) -> str:
    os.makedirs(data_dir, exist_ok=True)
    path = pid_path(data_dir)
    with open(path, "w") as f:
        f.write(str(pid or os.getpid()))
    return path


def read_pid(data_dir: str) -> Optional[int]:
    """Returns the live daemon pid, or None (stale files are cleaned)."""
    path = pid_path(data_dir)
    try:
        with open(path) as f:
            pid = int(f.read().strip())
    except (OSError, ValueError):
        return None
    if is_alive(pid):
        return pid
    clear_pid(data_dir)
    return None


def is_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except PermissionError:
        # EPERM: the process EXISTS but belongs to another user —
        # treating it as dead would delete a live daemon's pid file
        return True
    except ProcessLookupError:
        return False


def clear_pid(data_dir: str) -> None:
    try:
        os.remove(pid_path(data_dir))
    except OSError:
        pass


__all__ = ["write_pid", "read_pid", "clear_pid", "is_alive", "pid_path"]
