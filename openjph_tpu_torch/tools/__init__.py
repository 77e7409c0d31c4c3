"""Measurement tools of the port: ``python -m openjph_tpu_torch.tools.ab_upload``
A/Bs VideoDecoder's upload strategies in one process."""
