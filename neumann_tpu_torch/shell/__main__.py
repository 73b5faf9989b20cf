"""`python -m neumann_tpu_torch.shell` — the REPL on the card."""

from neumann_tpu_torch.shell.shell import main

if __name__ == "__main__":
    raise SystemExit(main())
