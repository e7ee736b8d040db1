"""The train, eval, test and fisher steps with the train CLI's remaining
knobs against the JAX package's in continual-learning mode: three steps over
the rna heads with the frozen teacher's distillation over cadence and EWC,
then the eval, test and fisher steps (``test_torch_port_variants_steps.py``
has the combined mode and the tolerances).
"""

from tests.test_torch_port_train import batches  # noqa: F401 (the fixture)
from tests.test_torch_port_variants_steps import run_variant_steps


def test_variant_continual_steps_match_jax(batches):  # noqa: F811 (the fixture)
    run_variant_steps(batches, "continual")
