"""Multi-device training of the port (torch.distributed): the mesh step
(dp.py), the mesh trainer (trainer.py) and process start-up (multihost.py)."""
