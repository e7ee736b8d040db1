"""Dataset acquisition: retrying downloads, checksums, archives, git clones
(counterpart of ``analysisgnn_tpu/data/download.py``, standard library only).

Re-implementation of the reference dataset plumbing (analysisgnn/data/
dataset.py): retrying ``download`` with exponential backoff (:100-182), sha1
content verification (:10-32), zip/tar extraction, shallow git clone with
branch fallback (``BuiltinDataset``, :424-498), and the cache-directory
override env var (``STRUTTURA_DOWNLOAD_DIR`` → here
``ANALYSISGNN_TPU_DATA_DIR``, :86-97, the JAX package's variable and
directory, so both packages share one cache).

Network access is optional by design: every function fails with a clear
error when offline, and nothing runs at import time.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tarfile
import time
import zipfile
from typing import Optional

DEFAULT_DIR = os.path.join(os.path.expanduser("~"), ".analysisgnn_tpu")


def get_download_dir() -> str:
    d = os.environ.get("ANALYSISGNN_TPU_DATA_DIR", DEFAULT_DIR)
    os.makedirs(d, exist_ok=True)
    return d


def sha1_of_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha1()
    with open(path, "rb") as f:
        while True:
            data = f.read(chunk)
            if not data:
                break
            h.update(data)
    return h.hexdigest()


def check_sha1(path: str, expected: str) -> bool:
    return sha1_of_file(path) == expected


def download(
    url: str,
    path: Optional[str] = None,
    overwrite: bool = False,
    sha1_hash: Optional[str] = None,
    retries: int = 5,
    verify_ssl: bool = True,
) -> str:
    """Retrying HTTP download (reference download(), data/dataset.py:100-182)."""
    import urllib.request

    fname = path or os.path.join(get_download_dir(), url.split("/")[-1])
    if os.path.isdir(fname):
        fname = os.path.join(fname, url.split("/")[-1])
    if os.path.exists(fname) and not overwrite:
        if sha1_hash is None or check_sha1(fname, sha1_hash):
            return fname
    os.makedirs(os.path.dirname(os.path.abspath(fname)), exist_ok=True)
    last_err: Optional[Exception] = None
    for attempt in range(retries):
        try:
            tmp = fname + ".part"
            urllib.request.urlretrieve(url, tmp)
            if sha1_hash and not check_sha1(tmp, sha1_hash):
                raise IOError(f"checksum mismatch for {url}")
            os.replace(tmp, fname)
            return fname
        except Exception as e:  # noqa: BLE001 — retry everything transient
            last_err = e
            time.sleep(min(2**attempt, 30))
    raise IOError(f"failed to download {url} after {retries} attempts: {last_err}")


def extract_archive(path: str, target_dir: str) -> str:
    os.makedirs(target_dir, exist_ok=True)
    if zipfile.is_zipfile(path):
        with zipfile.ZipFile(path) as z:
            z.extractall(target_dir)
    elif tarfile.is_tarfile(path):
        with tarfile.open(path) as t:
            t.extractall(target_dir)
    else:
        raise ValueError(f"unknown archive format: {path}")
    return target_dir


def clone_repo(
    url: str,
    target_dir: str,
    branch: Optional[str] = None,
    fallback_branches: tuple = ("main", "master"),
    depth: int = 1,
) -> str:
    """Shallow git clone with branch fallback (reference BuiltinDataset,
    data/dataset.py:424-498)."""
    if os.path.isdir(os.path.join(target_dir, ".git")):
        return target_dir
    branches = ([branch] if branch else []) + [
        b for b in fallback_branches if b != branch
    ]
    last: Optional[Exception] = None
    for b in branches:
        try:
            subprocess.run(
                ["git", "clone", "--depth", str(depth), "--branch", b, url, target_dir],
                check=True,
                capture_output=True,
                timeout=600,
            )
            return target_dir
        except Exception as e:  # try next branch
            last = e
            shutil.rmtree(target_dir, ignore_errors=True)
    raise IOError(f"failed to clone {url} (branches tried: {branches}): {last}")


# upstream corpus locations used by the reference datasets (recorded for
# parity; cloning requires network access):
CORPUS_SOURCES = {
    "cadence": "https://github.com/manoskary/cadence_xml_datasets",
    "dlc": "https://github.com/johentsch/dilemmadata",
    "augmentednet": "https://github.com/napulen/AugmentedNet",
}
