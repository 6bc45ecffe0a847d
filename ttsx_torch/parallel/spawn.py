"""Rank processes on this host: a free port for the group's address and
``n`` processes of one module, one rank each."""
from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path
from typing import List, Sequence

REPO = Path(__file__).resolve().parents[2]


def free_port() -> int:
    """A TCP port free on localhost now (for ``tcp://127.0.0.1:<port>``)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(module: str, n: int, args: Sequence[str] = (),
              timeout: float = 900.0) -> List[str]:
    """``python -m module *args --rank r --port P`` for r in 0..n-1, the
    repository on their path; waits for all and returns their output.
    Raises with the ends of their output if one fails; kills the others
    then."""
    port = free_port()
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(REPO), os.environ.get("PYTHONPATH", "")])}
    procs = [subprocess.Popen(
        [sys.executable, "-m", module, *args, "--rank", str(r), "--port",
         str(port)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(n)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    rcs = [p.returncode for p in procs]
    if any(rcs):
        raise RuntimeError(f"{module} over {n} ranks exited {rcs}:\n"
                           + "\n".join(log[-2000:] for log in logs))
    return logs
