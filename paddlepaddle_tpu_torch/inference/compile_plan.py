"""Compile plan + serving bundles — the port's cold start.

Port of ``paddlepaddle_tpu/inference/compile_plan.py``, in three parts:

* **CompilePlan** — the programs a :class:`~.decode_engine.BatchDecodeEngine`
  configuration implies, under the reference's keys: ``decode`` and one
  ``admit_p<bucket>`` per prompt bucket, and under speculation
  ``draft_admit_p<bucket>``, ``draft_k<k>`` and ``verify_k<k>`` instead of
  ``decode``. In the port a ``decode`` / ``draft_k`` / ``verify_k`` entry
  is a CUDA-graph capture on the card (the contiguous layout's decode
  program is registered as ``"decode_contig"``, the entry's ``program``),
  and an ``admit`` entry is an eager admission at that bucket: there is
  nothing to compile, but its first run warms cuBLAS and the caching
  allocator, so ``warmup()`` runs one.
* **Fingerprint** — a sha256 over the plan's *facts*: the reference's
  (model architecture, slots / length / chunk, KV layout and page
  geometry, quantization, speculation, the attention route), with the
  runtime facts the port's programs depend on in place of ``jax`` /
  ``jaxlib`` / ``platform`` / ``n_devices``: ``torch.__version__``,
  ``torch.version.cuda``, the device's name and compute capability, and
  the kernel libraries the engine launches, named by their content hash
  (``ops/kernels/_build.library_path``: the hash of the sources, shared
  headers and ``nvcc`` flags).
* **Bundle** — a directory holding ``manifest.json`` (format version,
  fingerprint, facts, keys) and the kernel libraries the plan launches,
  copied under their content-hashed names. The reference's bundle is the
  serialized XLA executables; a CUDA graph cannot be serialized, so the
  port's bundle carries what a fresh host would otherwise spend ``nvcc``
  on: loading one places each library into the kernel build directory,
  where the kernels load it in place of building it. The graphs are still
  captured by ``warmup()`` (seconds), never rebuilt from source.

Commit discipline mirrors the reference: bundles are written to a staging
directory and renamed into place, so a killed save leaves the previous
bundle intact or the path absent, never a half-written artifact.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import time
from typing import Dict, List, Optional, Tuple

BUNDLE_FORMAT_VERSION = 1
MANIFEST_NAME = "manifest.json"

# program keys (strings, so they double as file names):
#   "decode"                 — the chunked multi-step decode program
#   "admit_p<bucket>"        — admission prefill at one prompt bucket
#   "admit_pfx<n>t<bucket>"  — prefix-HIT admission (traffic-shaped; the
#                              port's hit runs the same eager admission)
#   "draft_admit_p<bucket>"  — speculative: draft-model prompt prefill
#   "draft_k<K>"             — speculative: K greedy draft proposals
#   "verify_k<K>"            — speculative: one batched target verify
_ADMIT_RE = re.compile(r"^admit_p(\d+)$")
_PREFIX_RE = re.compile(r"^admit_pfx(\d+)t(\d+)$")
_DRAFT_ADMIT_RE = re.compile(r"^draft_admit_p(\d+)$")
_DRAFT_RE = re.compile(r"^draft_k(\d+)$")
_VERIFY_RE = re.compile(r"^verify_k(\d+)$")


def decode_key() -> str:
    return "decode"


def admit_key(bucket: int) -> str:
    return f"admit_p{int(bucket)}"


def prefix_admit_key(n_pfx: int, tail_bucket: int) -> str:
    return f"admit_pfx{int(n_pfx)}t{int(tail_bucket)}"


def draft_admit_key(bucket: int) -> str:
    return f"draft_admit_p{int(bucket)}"


def draft_key(k: int) -> str:
    return f"draft_k{int(k)}"


def verify_key(k: int) -> str:
    return f"verify_k{int(k)}"


def parse_key(key: str) -> Tuple[str, Dict[str, int]]:
    """(kind, info) for a program key; raises ValueError on garbage so a
    tampered bundle entry fails loud."""
    if key == "decode":
        return "decode", {}
    m = _ADMIT_RE.match(key)
    if m:
        return "admit", {"bucket": int(m.group(1))}
    m = _PREFIX_RE.match(key)
    if m:
        return "prefix", {"n_pfx": int(m.group(1)),
                          "tail_bucket": int(m.group(2))}
    m = _DRAFT_ADMIT_RE.match(key)
    if m:
        return "draft_admit", {"bucket": int(m.group(1))}
    m = _DRAFT_RE.match(key)
    if m:
        return "draft", {"k": int(m.group(1))}
    m = _VERIFY_RE.match(key)
    if m:
        return "verify", {"k": int(m.group(1))}
    raise ValueError(f"unrecognized compile-plan program key {key!r}")


def prompt_buckets(max_len: int, q: int = 128) -> List[int]:
    """Every admission bucket: multiples of ``q`` below ``max_len``, then
    ``max_len`` itself (reference :127)."""
    buckets = []
    b = q
    while b < max_len:
        buckets.append(b)
        b += q
    buckets.append(int(max_len))
    return buckets


class PlanEntry:
    """One program the plan implies."""

    __slots__ = ("key", "kind", "meta")

    def __init__(self, key: str, kind: str, meta: Optional[Dict] = None):
        self.key = key
        self.kind = kind
        self.meta = dict(meta or {})

    def describe(self) -> Dict[str, object]:
        return {"key": self.key, "kind": self.kind, **self.meta}

    def __repr__(self):
        return f"PlanEntry({self.key})"


def runtime_facts(device) -> Dict[str, object]:
    """The runtime an engine's programs and kernel libraries belong to:
    the reference's ``jax`` / ``jaxlib`` / ``platform`` / ``n_devices``
    facts, for PyTorch on a card."""
    import torch

    dev = torch.device(device)
    facts: Dict[str, object] = {"torch": torch.__version__,
                                "cuda": torch.version.cuda,
                                "platform": dev.type}
    if dev.type == "cuda":
        facts["device_name"] = torch.cuda.get_device_name(dev)
        facts["capability"] = list(torch.cuda.get_device_capability(dev))
    return facts


class CompilePlan:
    """Program inventory for one engine configuration + the facts that
    make its programs exchangeable (the fingerprint)."""

    def __init__(self, entries: List[PlanEntry], facts: Dict[str, object],
                 libraries: Optional[List[str]] = None):
        self.entries = list(entries)
        self.facts = facts
        self.libraries = list(libraries or [])   # kernel sources launched
        self._fingerprint: Optional[str] = None

    @classmethod
    def for_engine(cls, engine) -> "CompilePlan":
        """Enumerate what ``engine``'s configuration implies (reference
        :146-233): one decode program (none under speculation, whose every
        chunk runs the draft and verify programs) and one admission per
        prompt bucket, and under speculation the draft admissions and the
        draft / verify programs."""
        from ..ops.kernels import _build

        cfg = engine.cfg
        model = {k: v for k, v in sorted(vars(cfg).items())
                 if isinstance(v, (int, float, str, bool, type(None)))}
        libraries = list(engine.kernel_libraries())
        facts: Dict[str, object] = {
            "model": model,
            "max_slots": engine.S,
            "max_len": engine.L,
            "chunk": engine.chunk,
            "kv_layout": engine.kv_layout,
            "page_size": engine.page_size,
            "num_pages": (engine.pool.num_pages
                          if engine.pool is not None else 0),
            "prefix_cache": bool(engine.prefix_enabled),
            "quant": engine.quant or "off",
            "quant_group_size": (engine.quant_meta.get("group_size", -1)
                                 if engine.quant else -1),
            "kv_quant": engine.kv_quant or "off",
            "mesh": None,
            "spec": (engine.spec.facts() if engine.spec is not None
                     else None),
            # the attention route the captured programs launch: the paged
            # kernel, its plain version, or the model's cached attention
            "fused": {"paged_attention": engine.fused["paged_attention"]},
            "dtype": str(engine._kv_dtype).replace("torch.", ""),
            **runtime_facts(engine.device),
            "kernels": {n: _build.library_path(n).name for n in libraries},
        }
        spec_on = engine.spec is not None
        entries = []
        if not spec_on:
            entries.append(PlanEntry(decode_key(), "decode",
                                     {"slots": engine.S,
                                      "chunk": engine.chunk,
                                      "program": engine._decode_key}))
        for b in prompt_buckets(engine.L):
            entries.append(PlanEntry(admit_key(b), "admit", {"bucket": b}))
        if spec_on:
            k = engine.spec.k
            for b in prompt_buckets(engine.L):
                entries.append(PlanEntry(draft_admit_key(b), "draft_admit",
                                         {"bucket": b}))
            entries.append(PlanEntry(draft_key(k), "draft", {"k": k}))
            entries.append(PlanEntry(verify_key(k), "verify", {"k": k}))
        return cls(entries, facts, libraries)

    def keys(self) -> List[str]:
        return [e.key for e in self.entries]

    def fingerprint(self) -> str:
        """Stable content hash of the facts (not of the entry list)."""
        if self._fingerprint is None:
            blob = json.dumps(self.facts, sort_keys=True, default=str)
            self._fingerprint = hashlib.sha256(blob.encode()).hexdigest()
        return self._fingerprint

    def describe(self) -> Dict[str, object]:
        """The ``health()`` compile-plan block."""
        return {
            "entries": len(self.entries),
            "keys": self.keys(),
            "fingerprint": self.fingerprint()[:16],
        }


class BundleMismatchError(RuntimeError):
    """A bundle exists but cannot serve this engine: fingerprint / version
    / integrity mismatch. Carries the differing fields so the fallback log
    says WHY the artifact was rejected."""

    def __init__(self, msg: str, mismatches: Optional[List[str]] = None):
        super().__init__(msg)
        self.mismatches = list(mismatches or [])


def _facts_diff(a: Dict, b: Dict) -> List[str]:
    keys = sorted(set(a) | set(b))
    return [k for k in keys if a.get(k) != b.get(k)]


def bundle_version_id(fingerprint: str, created_unix: float) -> str:
    """Short version id: the fingerprint's head plus the save second."""
    return f"{str(fingerprint)[:12]}@{int(created_unix)}"


def read_manifest(path: str) -> Dict[str, object]:
    """Load a bundle's manifest; one without a ``version`` gets one derived
    from its fingerprint and timestamp."""
    with open(os.path.join(path, MANIFEST_NAME)) as f:
        manifest = json.load(f)
    if not isinstance(manifest, dict):
        raise ValueError(f"{path}: manifest is not a JSON object")
    if not manifest.get("version"):
        manifest["version"] = bundle_version_id(
            manifest.get("fingerprint", "?"),
            manifest.get("created_unix", 0) or 0)
    return manifest


def _check_payloads(path: str, manifest: Dict[str, object]) -> None:
    for key in manifest.get("keys", []):
        parse_key(key)
    for lib in manifest.get("libraries", []):
        fpath = os.path.join(path, lib.get("file", ""))
        with open(fpath, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        if digest != lib.get("sha256"):
            raise BundleMismatchError(
                f"bundle library {lib.get('file')}: payload sha256 mismatch "
                "(corrupted or tampered artifact)", [str(lib.get("file"))])


def validate_bundle(path: str) -> Dict[str, object]:
    """Pre-flight a candidate bundle without an engine: the manifest
    parses, the format version is supported, a fingerprint is present,
    every key parses and every library matches its sha256. Returns the
    manifest; raises :class:`BundleMismatchError` / OSError / ValueError."""
    manifest = read_manifest(path)
    if manifest.get("format_version") != BUNDLE_FORMAT_VERSION:
        raise BundleMismatchError(
            f"bundle format {manifest.get('format_version')!r} != "
            f"{BUNDLE_FORMAT_VERSION}", ["format_version"])
    if not manifest.get("fingerprint"):
        raise BundleMismatchError("bundle manifest carries no fingerprint",
                                  ["fingerprint"])
    _check_payloads(path, manifest)
    return manifest


def save_bundle(engine, path: str,
                keys: Optional[List[str]] = None) -> Dict[str, object]:
    """Write the engine's bundle at ``path``: the manifest and every kernel
    library its plan launches (built first if it is not on disk). Returns
    the manifest. Atomic: staging directory + rename."""
    from ..ops.kernels import _build

    plan = engine.compile_plan
    if keys is None:
        keys = plan.keys()
    for key in keys:
        parse_key(key)                     # refuse unsaveable keys early
    if plan.libraries:
        _build.build_all(plan.libraries)
    staging = f"{path}.staging.{os.getpid()}"
    shutil.rmtree(staging, ignore_errors=True)
    os.makedirs(staging)
    t0 = time.perf_counter()
    try:
        libraries = []
        for name in plan.libraries:
            src = _build.library_path(name)
            shutil.copyfile(src, os.path.join(staging, src.name))
            with open(src, "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()
            libraries.append({"source": name, "file": src.name,
                              "bytes": src.stat().st_size,
                              "sha256": digest})
        created = time.time()
        manifest = {
            "format_version": BUNDLE_FORMAT_VERSION,
            "created_unix": round(created, 3),
            "version": bundle_version_id(plan.fingerprint(), created),
            "fingerprint": plan.fingerprint(),
            "facts": plan.facts,
            "keys": list(keys),
            "libraries": libraries,
        }
        with open(os.path.join(staging, MANIFEST_NAME), "w") as f:
            json.dump(manifest, f, indent=1, default=str)
        # committed-or-absent: the only non-atomic window is between
        # removing an OLD bundle and the rename
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.rename(staging, path)
    except BaseException:
        shutil.rmtree(staging, ignore_errors=True)
        raise
    manifest["save_wall_s"] = round(time.perf_counter() - t0, 3)
    return manifest


def load_bundle(engine, path: str) -> Dict[str, object]:
    """Check a bundle against ``engine``'s plan and place its kernel
    libraries in the build directory, so the kernels load them instead of
    running ``nvcc``. All-or-nothing: every check passes before any file
    is placed. Raises :class:`BundleMismatchError` (or OSError /
    ValueError) on any problem; the engine's non-strict wrapper turns that
    into a logged fallback."""
    from ..ops.kernels import _build

    manifest = read_manifest(path)
    if manifest.get("format_version") != BUNDLE_FORMAT_VERSION:
        raise BundleMismatchError(
            f"bundle format {manifest.get('format_version')!r} != "
            f"{BUNDLE_FORMAT_VERSION}", ["format_version"])
    plan = engine.compile_plan
    fp = plan.fingerprint()
    if manifest.get("fingerprint") != fp:
        diff = _facts_diff(manifest.get("facts") or {}, plan.facts)
        raise BundleMismatchError(
            f"bundle fingerprint {str(manifest.get('fingerprint'))[:16]} != "
            f"engine {fp[:16]} (differing facts: {', '.join(diff) or '?'})",
            diff)
    _check_payloads(path, manifest)
    by_source = {lib.get("source"): lib
                 for lib in manifest.get("libraries", [])}
    missing = [n for n in plan.libraries if n not in by_source]
    if missing:
        raise BundleMismatchError(
            f"bundle lacks the kernel libraries {missing}", missing)
    out_dir = _build.build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    for name in plan.libraries:
        target = _build.library_path(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        shutil.copyfile(os.path.join(path, by_source[name]["file"]), tmp)
        os.replace(tmp, target)
    return manifest
