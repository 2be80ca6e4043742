"""ms2020 through both packages' tfci CLIs on one model directory: the
checks of tests/test_torch_cli_interop.py, in a file of its own so that
test runs spread it over workers (it takes the longest)."""

from test_torch_cli_interop import check_both_clis_share_files, shared_dir  # noqa: F401


def test_both_clis_share_files_ms2020(shared_dir, capsys):  # noqa: F811
    check_both_clis_share_files(shared_dir, capsys, "ms2020")
