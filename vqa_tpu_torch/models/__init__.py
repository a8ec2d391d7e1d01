"""The port's model zoo (MutanAtt so far); see factory.py."""

from vqa_tpu_torch.models.factory import factory  # noqa: F401
