"""The checks of tests/test_torch_export.py on both packages' export CLIs
in bf16, as the CLIs load their models by default: the port's `.pt2`
programs against the JAX package's `.stablehlo` programs on the same numpy
inputs (cast to bf16) within 5e-2 of max |.| (the limit the port holds
bf16 to against float32; XLA and torch round bf16 at other places), the
flash op in the loaded flow_solve, and the three msgpack files' trees and
leaves equal (bf16 leaves of two or more dimensions). A file of its own,
so that each file stays under a minute in one process."""

import pytest

from test_torch_api import model_dir  # noqa: F401 (a fixture)
from test_torch_export import check_flow_solve_holds_the_op, check_msgpack_trees, check_programs, export_pass


@pytest.fixture(scope="module")
def exported(model_dir, tmp_path_factory):  # noqa: F811
    return export_pass(model_dir, tmp_path_factory.mktemp("export_bf16"), fp16=True)


def test_programs_match_jax(exported):
    check_programs(exported)


def test_flow_solve_program_holds_the_op(exported):
    check_flow_solve_holds_the_op(exported)


def test_msgpack_trees_equal(exported):
    check_msgpack_trees(exported)
