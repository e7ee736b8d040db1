"""The port's dataset acquisition (``data/download.py``) against the JAX
package's, offline: ``file://`` URLs, local archives and a local git
repository stand in for the network."""

import hashlib
import io
import shutil
import subprocess
import tarfile
import zipfile
from pathlib import Path

import pytest

from analysisgnn_tpu.data import download as jdl
from analysisgnn_tpu_torch.data import download as tdl

PAYLOAD = b"onset_div\tduration_div\n0\t4\n4\t8\n" * 50


def _tree(root: Path):
    return {p.relative_to(root).as_posix(): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("with_sha1", [False, True])
def test_download_of_a_file_url(with_sha1, tmp_path):
    src = tmp_path / "src" / "piece.tsv"
    src.parent.mkdir()
    src.write_bytes(PAYLOAD)
    sha1 = hashlib.sha1(PAYLOAD).hexdigest() if with_sha1 else None
    got = {}
    for name, mod in (("jax", jdl), ("port", tdl)):
        out = tmp_path / name
        out.mkdir()
        path = mod.download(src.as_uri(), path=str(out), sha1_hash=sha1)  # a directory: the URL's basename in it
        got[name] = (Path(path).relative_to(out).as_posix(), Path(path).read_bytes())
        assert not (out / "piece.tsv.part").exists()
        src.write_bytes(b"changed")  # an existing file is not fetched again (its checksum matches, or none is asked)
        assert mod.download(src.as_uri(), path=path, sha1_hash=sha1) == path
        assert Path(path).read_bytes() == PAYLOAD
        src.write_bytes(PAYLOAD)
    assert got["port"] == got["jax"] == ("piece.tsv", PAYLOAD)
    assert tdl.check_sha1(str(src), hashlib.sha1(PAYLOAD).hexdigest()) and tdl.sha1_of_file(str(src)) == \
        jdl.sha1_of_file(str(src))


def test_checksum_mismatch_raises_the_same_error(tmp_path, monkeypatch):
    src = tmp_path / "piece.tsv"
    src.write_bytes(PAYLOAD)
    sleeps = {"jax": [], "port": []}
    errors = {}
    for name, mod in (("jax", jdl), ("port", tdl)):
        monkeypatch.setattr(mod.time, "sleep", sleeps[name].append)
        with pytest.raises(IOError) as e:
            mod.download(src.as_uri(), path=str(tmp_path / f"{name}.tsv"), sha1_hash="0" * 40, retries=3)
        errors[name] = str(e.value)
        assert not (tmp_path / f"{name}.tsv").exists()
    assert errors["port"] == errors["jax"] and "checksum mismatch" in errors["port"]
    assert sleeps["port"] == sleeps["jax"] == [1, 2, 4]  # the backoff, min(2**attempt, 30)


def test_zip_and_tar_extract_to_equal_trees(tmp_path):
    files = {"all/a.tsv": PAYLOAD, "all/sub/b.tsv": PAYLOAD[:40], "test_split.json": b'["a"]'}
    zpath, tpath = tmp_path / "c.zip", tmp_path / "c.tar.gz"
    with zipfile.ZipFile(zpath, "w") as z:
        for name, data in files.items():
            z.writestr(name, data)
    with tarfile.open(tpath, "w:gz") as t:
        for name, data in files.items():
            info = tarfile.TarInfo(name)
            info.size = len(data)
            t.addfile(info, io.BytesIO(data))
    for archive in (zpath, tpath):
        trees = {}
        for name, mod in (("jax", jdl), ("port", tdl)):
            out = tmp_path / f"{name}_{archive.name}"
            assert mod.extract_archive(str(archive), str(out)) == str(out)
            trees[name] = _tree(out)
        assert trees["port"] == trees["jax"] == files
    bad = tmp_path / "c.txt"
    bad.write_bytes(PAYLOAD)
    with pytest.raises(ValueError, match="unknown archive format"):
        tdl.extract_archive(str(bad), str(tmp_path / "x"))


def test_clone_falls_back_to_master(tmp_path):
    if shutil.which("git") is None:
        pytest.skip("git is not installed")
    repo = tmp_path / "upstream"
    repo.mkdir()
    git = ["git", "-c", "user.name=t", "-c", "user.email=t@t", "-c", "init.defaultBranch=master"]
    subprocess.run(git + ["init", "-q", str(repo)], check=True)
    (repo / "README").write_text("corpus\n")
    subprocess.run(git + ["-C", str(repo), "add", "README"], check=True)
    subprocess.run(git + ["-C", str(repo), "commit", "-q", "-m", "one"], check=True)
    trees = {}
    for name, mod in (("jax", jdl), ("port", tdl)):
        target = tmp_path / name
        # "dev" and "main" do not exist: the clone falls back to "master"
        assert mod.clone_repo(repo.as_uri(), str(target), branch="dev") == str(target)
        branch = subprocess.run(["git", "-C", str(target), "rev-parse", "--abbrev-ref", "HEAD"], check=True,
                                capture_output=True, text=True).stdout.strip()
        trees[name] = (branch, (target / "README").read_text())
        assert mod.clone_repo("file:///nowhere", str(target)) == str(target)  # already cloned: nothing runs
    assert trees["port"] == trees["jax"] == ("master", "corpus\n")
    with pytest.raises(IOError, match=r"branches tried: \['dev', 'main', 'master'\]"):
        tdl.clone_repo((tmp_path / "missing").as_uri(), str(tmp_path / "none"), branch="dev")


def test_the_cache_directory_variable_is_honoured(tmp_path, monkeypatch):
    cache = tmp_path / "cache" / "nested"
    monkeypatch.setenv("ANALYSISGNN_TPU_DATA_DIR", str(cache))
    assert tdl.get_download_dir() == jdl.get_download_dir() == str(cache) and cache.is_dir()
    src = tmp_path / "piece.tsv"
    src.write_bytes(PAYLOAD)
    assert tdl.download(src.as_uri()) == str(cache / "piece.tsv")
    monkeypatch.delenv("ANALYSISGNN_TPU_DATA_DIR")
    assert tdl.DEFAULT_DIR == jdl.DEFAULT_DIR and tdl.CORPUS_SOURCES == jdl.CORPUS_SOURCES
