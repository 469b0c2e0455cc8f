"""Test harness config.

By default everything runs on the CPU with 8 virtual devices: sharding tests
exercise `jax.sharding.Mesh` semantics on forced host devices, and the Pallas
QP kernel runs in interpret mode. With GPMPC_TEST_PLATFORM=gpu the platform is
left to JAX (the card) and float64 stays off; that is how the tests marked
`gpu` run on the card:

    GPMPC_TEST_PLATFORM=gpu python -m pytest -m gpu tests/

Tests marked `gpu` decide inside their fixture whether a card is present and
skip on the CPU, so every worker collects the same tests.
"""

import os
import resource

# The XLA:CPU compiler recurses deeply on the biggest interpret-mode Pallas
# programs in this suite (the lanes-episode scan) and can overflow the default
# 8 MiB stack — observed as a deterministic SIGSEGV in backend_compile_and_load
# when the full suite runs in one process. Raise the soft limit before the
# first compile: the main-thread stack VMA grows on demand up to this limit,
# and glibc sizes new (compiler-pool) thread stacks from the soft limit at
# thread-creation time.
_stack_hard = resource.getrlimit(resource.RLIMIT_STACK)[1]
resource.setrlimit(
    resource.RLIMIT_STACK,
    (min(512 * 1024 * 1024, _stack_hard if _stack_hard > 0 else 512 * 1024 * 1024),
     _stack_hard),
)

ON_CARD = os.environ.get("GPMPC_TEST_PLATFORM") == "gpu"
if not ON_CARD:
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    )
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Drop compiled executables after each test module.

    The suite compiles hundreds of XLA:CPU programs in one process; keeping
    them all alive bloats the address space until the biggest late-suite
    compiles (the interpret-mode lanes-episode scan) segfault inside the
    XLA:CPU compiler — observed deterministically at ~90 tests in, while the
    same test passes in any smaller run. Cross-module cache hits are rare
    (each module compiles its own program shapes), so this costs little."""
    yield
    jax.clear_caches()

if not ON_CARD:
    jax.config.update("jax_platforms", "cpu")
    # Allow float64 in tests: exactness oracles (dense KKT, closed-form GP
    # algebra) compare in f64; production code paths pin explicit float32
    # dtypes regardless.
    jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """The card, for tests marked `gpu`; they skip where JAX finds none."""
    if jax.default_backend() != "gpu":
        pytest.skip(
            "needs an NVIDIA GPU: run `GPMPC_TEST_PLATFORM=gpu python -m pytest "
            "-m gpu tests/` on the card"
        )
    return jax.devices()[0]
