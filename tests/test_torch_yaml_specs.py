"""The declarative YAML REST specs against a node of the PyTorch build.

The same 38 suites (``tests/rest_specs/*.yml``) and the same runner
(``tests/yaml_runner.py``) as ``tests/test_yaml_specs.py``, which drives
the JAX package's node, here driven through ``elasticsearch_tpu_torch``'s
REST controller on an ``InProcessCluster(device="cpu")`` -- every kernel
wrapper runs its plain PyTorch version. A spec that needs a feature the
port refuses with NotPortedError (status 501) is a strict xfail naming
the site that refuses it; every other spec must pass.
"""

from pathlib import Path

import pytest

from elasticsearch_tpu_torch.rest.controller import RestRequest
from elasticsearch_tpu_torch.rest.routes import build_controller
from elasticsearch_tpu_torch.testing import InProcessCluster

from tests.yaml_runner import YamlSpecRunner, load_specs

SPEC_DIR = Path(__file__).parent / "rest_specs"

# spec -> the NotPortedError site that stops it
NOT_PORTED = {
    "84_percolate/percolate: stored queries match candidate documents":
        "501 dense_query:Percolate, elasticsearch_tpu_torch/search/"
        "execute.py:184 (search/percolate.py is not ported)",
    "89_suggest/term suggester corrects typos":
        "501 suggest, elasticsearch_tpu_torch/action/search_action.py:1178"
        " (search/suggest.py is not ported)",
    "90_geo/geo_distance filtering":
        "501 dense_query:GeoDistance, elasticsearch_tpu_torch/search/"
        "execute.py:184 (the geo query nodes are not ported)",
    "91_nested_objects/nested field queries match within one object":
        "501 dense_query:Nested, elasticsearch_tpu_torch/search/"
        "execute.py:184 (the nested query node is not ported)",
}


def _param(name, steps):
    reason = NOT_PORTED.get(name)
    marks = [pytest.mark.xfail(strict=True, reason=reason)] if reason else []
    return pytest.param(name, steps, id=name, marks=marks)


SPECS = [_param(name, steps) for name, steps in load_specs(SPEC_DIR)]


@pytest.fixture()
def cluster():
    c = InProcessCluster(n_nodes=2, seed=29, device="cpu")
    c.start()
    yield c
    c.stop()


@pytest.mark.parametrize("name,steps", SPECS)
def test_torch_yaml_spec(cluster, name, steps):
    controller = build_controller(cluster.client())

    def do_request(method, path, body=None, query=None):
        import json as _json
        raw = b""
        if isinstance(body, list):
            # bulk/msearch NDJSON convention: a list body ships as raw
            # newline-delimited JSON
            raw = ("\n".join(_json.dumps(x) for x in body) + "\n"
                   ).encode("utf-8")
            body = None
        req = RestRequest(method=method, path=path,
                          query=dict(query or {}), body=body,
                          raw_body=raw)
        out = []
        controller.dispatch(req, lambda s, b: out.append((s, b)))
        cluster.run_until(lambda: bool(out), 120.0)
        return out[0]

    runner = YamlSpecRunner(do_request)
    for step in steps:
        runner.run_step(step)
