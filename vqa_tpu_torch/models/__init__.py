"""The port's model zoo (all nine archs of ``vqa_tpu/models``, for inference);
see factory.py."""

from vqa_tpu_torch.models.factory import factory  # noqa: F401
