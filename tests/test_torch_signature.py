"""The port's signature-provider registry against the JAX package's.

tests/test_signature.py's `test_provider_registry` through both packages:
a provider registered with `register_signature_provider` is created by
name. Added here: registration under threads loses no provider, an
unknown name raises, and the file-based provider is registered under the
JAX package's name in both.
"""

from __future__ import annotations

import threading

import pytest

import hyperspace_tpu.signature as jsig
import hyperspace_tpu_torch.signature as tsig
from hyperspace_tpu.exceptions import HyperspaceError as JHyperspaceError
from hyperspace_tpu.metadata.log_entry import Fingerprint as JFingerprint
from hyperspace_tpu_torch.exceptions import HyperspaceError as THyperspaceError
from hyperspace_tpu_torch.metadata.log_entry import Fingerprint as TFingerprint

PKGS = {"jax": (jsig, JFingerprint, JHyperspaceError), "torch": (tsig, TFingerprint, THyperspaceError)}


@pytest.fixture(params=tuple(PKGS))
def P(request):
    sig, fp, err = PKGS[request.param]
    saved = dict(sig._REGISTRY)
    yield sig, fp, err
    with sig._REGISTRY_LOCK:
        sig._REGISTRY.clear()
        sig._REGISTRY.update(saved)


def _provider(sig, fp, name, value):
    class Fake(sig.SignatureProvider):
        def signature(self, plan):
            return fp(name, value)

    Fake.name = name
    return Fake


def test_provider_registry(P):
    sig, fp, _ = P
    sig.register_signature_provider(_provider(sig, fp, "fake", "1"))
    assert sig.create_signature_provider("fake").signature(None).value == "1"


def test_registration_under_threads_loses_no_provider(P):
    sig, fp, _ = P
    barrier = threading.Barrier(8)

    def register(i):
        barrier.wait()
        for j in range(25):
            sig.register_signature_provider(_provider(sig, fp, f"fake{i}.{j}", f"{i}.{j}"))

    threads = [threading.Thread(target=register, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i in range(8):
        for j in range(25):
            assert sig.create_signature_provider(f"fake{i}.{j}").signature(None).value == f"{i}.{j}"


def test_unknown_provider_raises_and_file_based_is_registered(P):
    sig, _, err = P
    with pytest.raises(err, match="unknown signature provider"):
        sig.create_signature_provider("nope")
    assert isinstance(sig.create_signature_provider("fileBased"), sig.FileBasedSignatureProvider)
    assert set(jsig._REGISTRY) >= {"fileBased"} and "fileBased" in tsig._REGISTRY
