"""Command line tools: the port's copies of the root ``tools/`` (run as
``python -m nnc_tpu_torch.tools.<name>``) and scripts that measure the port
on the card. The package's own modules import none of them."""
