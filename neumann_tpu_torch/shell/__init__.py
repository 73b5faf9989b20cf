"""Interactive shell (REPL) on the PyTorch port — the `neumann` CLI
equivalent (port of ``neumann_tpu/shell``)."""

from neumann_tpu_torch.shell.shell import Shell, format_result  # noqa: F401
