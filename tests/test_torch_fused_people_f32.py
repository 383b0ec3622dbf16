"""The fused LM evaluation of the PyTorch port WITH valid people (plain K6, K1
and K2 with its social-work, agent-angle and proxemics stages), in
float32 against the JAX package's fused pipeline with its Pallas kernels in
interpret mode, for the social, six-agent and stress-horizon
configurations and a mixed batch; the protocol is
``test_torch_common.check_value_grad_with_people``."""

import numpy as np
import pytest
import torch
from test_torch_common import PEOPLE_BATCHES, check_value_grad_with_people

torch.set_num_threads(1)


@pytest.mark.parametrize("batch", list(PEOPLE_BATCHES))
def test_value_grad_with_people_matches_reference(batch):
    check_value_grad_with_people(batch, np.float32)
