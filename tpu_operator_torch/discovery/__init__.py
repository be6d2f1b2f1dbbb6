"""GPU feature discovery (``tfd.py``): the node labels that describe the
cards.

    python -m tpu_operator_torch.discovery --node-name <node> [--once]
"""
