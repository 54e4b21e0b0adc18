"""``python -m topo4d_tpu_torch``: the command-line fit (``cli.main``)."""

from topo4d_tpu_torch.cli import main

if __name__ == "__main__":
    main()
