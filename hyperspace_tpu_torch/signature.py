"""Plan signature providers: fingerprint the *data* a plan reads.

Reference parity: index/FileBasedSignatureProvider.scala:30-75 — fold an MD5
over (size, mtime, path) of every file in each scan leaf; an index matches a
plan iff the stored fingerprint equals the recomputed one. Providers are
looked up by name (reference uses reflection by class name,
index/LogicalPlanSignatureProvider.scala:55-62). A copy of the JAX
package's module: the fingerprint must match across packages for an
index built by one to serve the other. `plan_signature` fingerprints the
plan itself, for the plan cache (serve/plan_cache.py).
"""

from __future__ import annotations

import hashlib

from hyperspace_tpu_torch.dataset import format_suffix, list_data_files
from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.metadata.log_entry import Fingerprint
from hyperspace_tpu_torch.plan.nodes import LogicalPlan, Scan


def collect_leaf_files(leaf: Scan) -> list:
    """Enumerate a scan leaf's files as FileInfo, honoring pinned subsets."""
    import os

    from hyperspace_tpu_torch.metadata.log_entry import FileInfo

    if leaf.files is not None:
        out = []
        for path in sorted(leaf.files):
            st = os.stat(path)
            out.append(FileInfo(path, st.st_size, st.st_mtime_ns))
        return out
    return list_data_files(leaf.root, suffix=format_suffix(leaf.format))


def fingerprint_files(files) -> str:
    """Delimited MD5 fold over (size, mtime, path) identities — the same
    contract as FileBasedSignatureProvider.scala:48-74, with explicit field
    separators so distinct (size, mtime) pairs cannot collide."""
    h = hashlib.md5()
    for fi in files:
        h.update(f"{fi.size},{fi.mtime_ns},{fi.path}\0".encode())
    return h.hexdigest()


def plan_signature(plan: LogicalPlan) -> str:
    """Structural fingerprint of a logical plan: an MD5 over its canonical
    JSON serialization (sorted keys, so dict ordering cannot perturb it).
    Two plans with the same signature ask the same question of the same
    sources; the plan cache keys on this plus the data fingerprint and the
    index-collection log versions (serve/plan_cache.py)."""
    import json

    payload = json.dumps(plan.to_json(), sort_keys=True, default=str)
    return hashlib.md5(payload.encode()).hexdigest()


class SignatureProvider:
    name: str = "base"

    def signature(self, plan: LogicalPlan) -> Fingerprint | None:
        """Return the plan's data fingerprint, or None if this provider
        cannot fingerprint the plan (e.g. a leaf kind it doesn't know)."""
        raise NotImplementedError


class FileBasedSignatureProvider(SignatureProvider):
    name = "fileBased"

    def signature(self, plan: LogicalPlan) -> Fingerprint | None:
        leaves = plan.leaves()
        if not leaves:
            return None
        files = []
        for leaf in leaves:
            if not isinstance(leaf, Scan):
                return None
            files.extend(collect_leaf_files(leaf))
        return Fingerprint(kind=self.name, value=fingerprint_files(files))


_REGISTRY: dict[str, type[SignatureProvider]] = {
    FileBasedSignatureProvider.name: FileBasedSignatureProvider,
}


def create_signature_provider(name: str = "fileBased") -> SignatureProvider:
    provider = _REGISTRY.get(name)
    if provider is None:
        raise HyperspaceError(f"unknown signature provider {name!r}")
    return provider()
