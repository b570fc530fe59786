from repro_torch.serving.engine import RequestResult, ServingEngine, summarize  # noqa: F401
from repro_torch.serving.runner import ModelRunner  # noqa: F401
from repro_torch.serving.workload import (  # noqa: F401
    Context, Request, make_contexts, poisson_requests,
)
