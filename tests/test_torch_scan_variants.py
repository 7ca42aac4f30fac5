"""The committed design variants of K1/K2 (unified diffs against
csrc/ffd_scan.cu), of K3 (against csrc/ffd_scan_affinity.cu) and of K4
(against csrc/fit_reduce.cu), timed by
``autoscaler_tpu_torch.tools.scan_variants``, still apply to the sources
as they stand, and the applier is strict."""
import pytest

from autoscaler_tpu_torch.ops import _build
from autoscaler_tpu_torch.tools.scan_variants import (
    AFF_PATCH_DIR,
    FIT_PATCH_DIR,
    PATCH_DIR,
    apply_patch,
)

PATCHES = sorted(p.name for p in PATCH_DIR.glob("*.patch"))
ENTRIES = ("int ffd_scan_f32(", "int ffd_scan_swar(", "int ffd_scan_smem_bytes(")
AFF_PATCHES = sorted(p.name for p in AFF_PATCH_DIR.glob("*.patch"))
AFF_ENTRIES = ("int ffd_scan_aff(", "int ffd_scan_aff_smem_bytes(")
FIT_PATCHES = sorted(p.name for p in FIT_PATCH_DIR.glob("*.patch"))
FIT_ENTRIES = ("int fit_reduce(", "int fit_reduce_smem_bytes(")


def test_variants_are_committed():
    assert len(PATCHES) >= 10


@pytest.mark.parametrize("name", PATCHES)
def test_variant_applies_to_the_source(name):
    source = _build.source("ffd_scan").read_text()
    patch = (PATCH_DIR / name).read_text()
    assert not patch.startswith(("---", "@@")), "the first line says what the variant changes"
    text = apply_patch(source, patch)
    assert text != source
    for entry in ENTRIES:
        assert text.count(entry) == 1, f"{name} loses {entry}"


def test_aff_variants_are_committed():
    names = {name.removesuffix(".patch") for name in AFF_PATCHES}
    assert {"stage1", "stage12"} <= names and len(names) >= 6


@pytest.mark.parametrize("name", AFF_PATCHES)
def test_aff_variant_applies_to_the_source(name):
    source = _build.source("ffd_scan_affinity").read_text()
    patch = (AFF_PATCH_DIR / name).read_text()
    assert not patch.startswith(("---", "@@")), "the first line says what the variant changes"
    text = apply_patch(source, patch)
    assert text != source
    for entry in AFF_ENTRIES:
        assert text.count(entry) == 1, f"{name} loses {entry}"


def test_fit_variants_are_committed():
    names = {name.removesuffix(".patch") for name in FIT_PATCHES}
    assert {"stage1", "ballot", "pods2", "pods8", "tile128", "tile512", "byte-lookup"} <= names


@pytest.mark.parametrize("name", FIT_PATCHES)
def test_fit_variant_applies_to_the_source(name):
    source = _build.source("fit_reduce").read_text()
    patch = (FIT_PATCH_DIR / name).read_text()
    assert not patch.startswith(("---", "@@")), "the first line says what the variant changes"
    text = apply_patch(source, patch)
    assert text != source
    for entry in FIT_ENTRIES:
        assert text.count(entry) == 1, f"{name} loses {entry}"


def test_apply_patch_edits_in_place_and_refuses_a_missing_hunk():
    text = "a\nb\nc\nd\n"
    patch = "what\n--- a/f\n+++ b/f\n@@ -2,2 +2,2 @@\n b\n-c\n+C\n"
    assert apply_patch(text, patch) == "a\nb\nC\nd\n"
    with pytest.raises(ValueError):
        apply_patch(text, patch.replace(" b\n", " x\n"))
