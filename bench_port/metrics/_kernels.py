"""The port's kernels by name: every prefix listed in
``kernel_names/*.txt`` beside this file."""

import re
from pathlib import Path

HERE = Path(__file__).resolve().parent


def prefixes() -> tuple:
    out = []
    for path in sorted((HERE / "kernel_names").glob("*.txt")):
        for line in path.read_text().splitlines():
            line = line.split("#", 1)[0].strip()
            if line:
                out.append(line)
    return tuple(out)


def identifier(name: str) -> str:
    """A device operation's function name, without ``void``, namespaces,
    template arguments or parameters."""
    n = name.replace("(anonymous namespace)::", "")
    if n.startswith("void "):
        n = n[5:]
    m = re.match(r"[\w:]+", n)
    return m.group(0).split("::")[-1] if m else n


def is_port_kernel(name: str, table: tuple) -> bool:
    ident = identifier(name)
    if ident.startswith("_Z"):  # a mangled name: <length><identifier>
        return any(re.search(rf"\d{re.escape(p)}", ident) for p in table)
    return ident.startswith(table)


def split_ms(run):
    """(port kernels' device ms a call, other device ms a call) over the
    traced calls, or None without a trace."""
    tr = run.trace
    if not tr or not tr.get("calls") or not tr.get("device_ops"):
        return None
    table = prefixes()
    own = sum(s for n, s in tr["device_ops"].items()
              if is_port_kernel(n, table))
    rest = sum(tr["device_ops"].values()) - own
    return 1e3 * own / tr["calls"], 1e3 * rest / tr["calls"]
