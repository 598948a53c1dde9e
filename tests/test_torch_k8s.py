"""The port's Kubernetes client and its YAML reader and writer
(``opsagent_tpu_torch/k8s``, ``utils/yamlio.py``) against the JAX package's
client and PyYAML, on the CPU.

- tests/test_k8s.py's fake API server cases run against both clients: the
  same YAML text for a live object, the same discovery aliases, the same
  server-side apply requests (path, query, content type, body bytes, auth)
  and the same errors; a kubeconfig file parses to the same config.
- ``yamlio.safe_dump`` is byte-equal to ``yaml.safe_dump`` (the arguments the
  client uses: ``sort_keys=False, allow_unicode=True`` for GET-as-YAML, the
  defaults for apply), and ``yamlio.safe_load_all`` equal to
  ``yaml.safe_load_all``, on a corpus: ``configs/config.yaml``, the three
  ``deploy/kubernetes/*.yaml``, the fake server's objects, a kubeconfig,
  multi-line, quoted, unicode and empty values, and block scalars, flow
  collections and comments on the reading side.
"""

import base64
import glob
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer

import pytest
import yaml

from opsagent_tpu.k8s import client as jclient
from opsagent_tpu_torch.k8s import client as pclient
from opsagent_tpu_torch.utils import config as pconfig
from opsagent_tpu_torch.utils import yamlio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIENTS = {"jax": jclient, "torch": pclient}

POD = {
    "apiVersion": "v1",
    "kind": "Pod",
    "metadata": {"name": "mypod", "namespace": "default",
                 "labels": {"app": "web", "tier": "front"},
                 "annotations": {"note": "multi\nline: text", "empty": "", "num": "8080",
                                 "yes": "yes", "ümlaut": "日本語の説明"}},
    "spec": {"containers": [{"name": "c", "image": "nginx:1.25",
                             "args": ["--port", "8080", "-v", "'quoted'", "a: b"],
                             "env": [{"name": "X", "value": "1.5"},
                                     {"name": "Y", "value": None}],
                             "resources": {}, "ports": []}],
             "nodeSelector": {"kubernetes.io/os": "linux"}},
    "status": {"phase": "Running", "ready": True, "restarts": 0,
               "message": "a long status message " * 8},
}
DISCOVERY = {
    "/api/v1": {"resources": [
        {"name": "pods", "singularName": "pod", "kind": "Pod", "namespaced": True,
         "shortNames": ["po"]},
        {"name": "pods/log", "singularName": "", "kind": "Pod", "namespaced": True},
        {"name": "namespaces", "singularName": "namespace", "kind": "Namespace",
         "namespaced": False, "shortNames": ["ns"]},
    ]},
    "/apis": {"groups": [{"name": "apps", "preferredVersion": {"groupVersion": "apps/v1"}}]},
    "/apis/apps/v1": {"resources": [
        {"name": "deployments", "singularName": "deployment", "kind": "Deployment",
         "namespaced": True, "shortNames": ["deploy"]}]},
}
KUBECONFIG = {
    "apiVersion": "v1",
    "kind": "Config",
    "current-context": "ctx",
    "contexts": [{"name": "ctx", "context": {"cluster": "c1", "user": "u1", "namespace": "ops"}},
                 {"name": "other", "context": {"cluster": "c2", "user": "u2"}}],
    "clusters": [{"name": "c1", "cluster": {"server": "https://k8s.example:6443",
                                             "certificate-authority-data":
                                                 base64.b64encode(b"fake-ca").decode()}},
                 {"name": "c2", "cluster": {"server": "http://127.0.0.1:8001",
                                             "insecure-skip-tls-verify": True}}],
    "users": [{"name": "u1", "user": {"token": "secret"}}, {"name": "u2", "user": {}}],
    "preferences": {},
}
MANIFESTS = """
# two documents and a comment
apiVersion: apps/v1
kind: Deployment
metadata:
  name: web
  namespace: default
  annotations:
    description: >
      folded text over
      two lines
spec:
  replicas: 2
  template:
    spec:
      containers:
        - name: web
          image: "nginx:1.25"
          command: ["sh", "-c", 'echo "hi" && sleep 1']
          env:
          - {name: MODE, value: prod}
---
apiVersion: v1
kind: Namespace
metadata:
  name: staging
  labels: {team: ops, cost-center: '42'}
data:
  script.sh: |
    #!/bin/bash
    echo "multi: line"

    exit 0
...
"""


class FakeAPIServer(BaseHTTPRequestHandler):
    applied: list = []

    def _json(self, obj, status=200):
        body = json.dumps(obj).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):
        pass

    def do_GET(self):
        if self.path in DISCOVERY:
            self._json(DISCOVERY[self.path])
        elif self.path == "/api/v1/namespaces/default/pods/mypod":
            self._json(POD)
        else:
            self._json({"kind": "Status", "message": "not found"}, status=404)

    def do_PATCH(self):
        body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
        FakeAPIServer.applied.append({
            "path": self.path, "content_type": self.headers.get("Content-Type"),
            "body": body.decode(), "auth": self.headers.get("Authorization", ""),
        })
        self._json({"status": "ok"})


@pytest.fixture
def apiserver():
    FakeAPIServer.applied = []
    server = HTTPServer(("127.0.0.1", 0), FakeAPIServer)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()


def both(fn):
    out = {}
    for name, mod in CLIENTS.items():
        try:
            out[name] = fn(mod)
        except Exception as e:  # noqa: BLE001 - compared across packages
            out[name] = (type(e).__name__, str(e))
    assert out["torch"] == out["jax"]
    return out["jax"]


# -- the client against the fake API server -------------------------------------

@pytest.mark.parametrize("resource", ("pod", "po", "pods", "Pod"))
def test_get_yaml(resource, apiserver):
    out = both(lambda m: m.K8sClient(m.KubeConfig(server=apiserver, token="tok"))
               .get_yaml(resource, "mypod", "default"))
    assert yaml.safe_load(out) == POD


@pytest.mark.parametrize("resource", ("frob", "pods/log"))
def test_unknown_resource(resource, apiserver):
    out = both(lambda m: m.K8sClient(m.KubeConfig(server=apiserver)).get_yaml(resource, "x"))
    assert out[0] == "K8sError"


def test_missing_object_and_discovery(apiserver):
    out = both(lambda m: m.K8sClient(m.KubeConfig(server=apiserver)).get_yaml("ns", "x"))
    assert out[0] == "K8sError" and "HTTP 404" in out[1]
    both(lambda m: sorted(m.K8sClient(m.KubeConfig(server=apiserver))._discover().items()))


def test_apply_yaml_server_side(apiserver):
    def run(m):
        FakeAPIServer.applied = []
        applied = m.K8sClient(m.KubeConfig(server=apiserver, token="tok")).apply_yaml(MANIFESTS)
        return applied, FakeAPIServer.applied

    applied, requests = both(run)
    assert applied == ["Deployment/web", "Namespace/staging"]
    first = requests[0]
    assert first["path"].startswith("/apis/apps/v1/namespaces/default/deployments/web")
    assert "fieldManager=application%2Fapply-patch" in first["path"]
    assert first["content_type"] == "application/apply-patch+yaml"
    assert first["auth"] == "Bearer tok"
    assert requests[1]["path"].startswith("/api/v1/namespaces/staging")
    assert [yaml.safe_load(r["body"]) for r in requests] == list(yaml.safe_load_all(MANIFESTS))


@pytest.mark.parametrize("manifest", ("kind: Pod\nmetadata: {}\n", "---\n---\n", ""))
def test_apply_yaml_missing_fields(manifest, apiserver):
    both(lambda m: m.K8sClient(m.KubeConfig(server=apiserver)).apply_yaml(manifest))


@pytest.mark.parametrize("context", ("ctx", "other", "missing"))
def test_kubeconfig_file_parse(context, tmp_path):
    cfg_file = tmp_path / "config"
    cfg_file.write_text(yaml.safe_dump({**KUBECONFIG, "current-context": context}))

    def load(m):
        cfg = m._load_kubeconfig_file(str(cfg_file))
        ca = open(cfg.ca_cert_path, "rb").read() if cfg.ca_cert_path else b""
        return (cfg.server, cfg.token, cfg.namespace, cfg.insecure, ca)

    out = both(load)
    if context == "ctx":
        assert out == ("https://k8s.example:6443", "secret", "ops", False, b"fake-ca")


# -- yamlio against PyYAML --------------------------------------------------------

def corpus_files():
    return [os.path.join(REPO, "configs", "config.yaml")] + sorted(
        glob.glob(os.path.join(REPO, "deploy", "kubernetes", "*.yaml")))


def corpus_objects():
    objs = [POD, KUBECONFIG, *DISCOVERY.values()]
    for path in corpus_files():
        with open(path, encoding="utf-8") as f:
            objs.extend(yaml.safe_load_all(f))
    objs += list(yaml.safe_load_all(MANIFESTS))
    objs += [
        {"multi": "line one\nline two\n", "trailing": "ends with space ", "lead": " x",
         "blank_lines": "a\n\n\nb", "crlf": "a\r\nb", "tab": "a\tb", "bell": "a\x07b",
         "unicode": "naïve café ☕ 中文", "nbsp": "a\xa0b", "sep": "a\u2028b", "bom": "\ufeffx",
         "empty": "", "none": None, "quote'": "it's", 'dq"': 'say "hi"', "colon": "a: b",
         "hash": "a #b", "dash": "- x", "star": "*x", "bool_str": "true", "yes": "Yes",
         "null_str": "null", "tilde": "~", "int_str": "007", "hex": "0x1F", "float_str": "1e3",
         "date": "2024-01-02", "num": 12, "neg": -3, "float": 2.5, "big": 1e300, "tiny": 1e-300,
         "inf": float("inf"), "true": True, 7: "int key", "nested": [[], {}, [1, [2, []]]],
         "long": "word " * 40, "long_quoted": "it's a 'long' line " * 10,
         "long_escaped": "tab\tand more words " * 12, "path": "/var/run/secrets:ro",
         "percent": "%d", "at": "@home", "brace": "{x}", "amp": "&a", "pipe": "| x"},
        ["a", "- b", {"k": ["v", {"deep": "x\ny"}]}, None, ""],
        "just a scalar", "", None, 3, [], {},
    ]
    return objs


@pytest.mark.parametrize("kw", ({"sort_keys": False, "allow_unicode": True}, {}),
                         ids=("get_yaml", "apply"))
def test_dump_is_byte_equal_to_pyyaml(kw):
    objs = corpus_objects()
    assert len(objs) > 30
    for obj in objs:
        assert yamlio.safe_dump(obj, **kw) == yaml.safe_dump(obj, **kw), obj


@pytest.mark.parametrize("kw", ({"sort_keys": False, "allow_unicode": True}, {}),
                         ids=("get_yaml", "apply"))
def test_load_reads_back_what_pyyaml_dumps(kw):
    for obj in corpus_objects():
        text = yaml.safe_dump(obj, **kw)
        assert yamlio.safe_load(text) == yaml.safe_load(text), text


READ_CASES = {
    "block_scalars": "a: |\n  line1\n  line2\n\n  line4\nb: |-\n  x\n\n\nc: >\n  folded\n"
                     "  text\n\n  para\n    more\n  end\nd: >+\n  keep\n\n\ne: |2\n    in\n  b\n",
    "quoted": "k1: 'it''s'\nk2: \"esc \\t \\u00e9 \\x41 \\\\ \\\"\"\nk3: plain # comment\n"
              "k4: \"multi\n  line\"\nk5: 'also\n\n  multi'\nk6: \"joined\\\n  \\ on\"\n",
    "flow": "list: [a, 'b c', \"d\", 1, 2.5, true, null, {x: 1, y: [2, 3]}]\nempty: {}\n"
            "e2: [ ]\nmulti: [one,\n  two, three]\nmap: {a: 1, b, c: }\n",
    "documents": "# c\n---\na: 1\n---\n# only comment\n---\nb: 2\n...\n---\nc: 3\n",
    "scalars": "x: yes\ny: No\nz: 0o17\nw: 0x1F\nv: 017\nu: 1_000\nt: 1:30\ns: 2024-01-02\n"
               "r: 2024-01-02T10:20:30Z\nq: .inf\np: -.Inf\no: ~\nn: 1e3\nm: 1.0e+3\nl: +12\n"
               "k: 0b101\nj: 190:20:30.15\ni: .NaN\n",
    "nesting": "a:\n  b:\n    - c\n    - d:\n        e: f\n      g: h\n  i: []\n"
               "j:\n- 1\n- - 2\n  - 3\n-\n",
    "keys": "url: http://x:80/y\n\"quoted key\": 1\n'sq': 2\n1: one\ntrue: t\n~: n\n",
    "plain_multiline": "text: a plain scalar\n  folded over\n\n  lines\nnext: x\n",
    "empty_values": "a:\nb: ''\nc: \"\"\nd: []\ne:\n  # nothing\nf: ~\n",
    "top_level_list": "- a\n- b: c\n  d: e\n- [x, y]\n",
    "top_level_scalar": "--- just text\n",
    "configs": open(os.path.join(REPO, "configs", "config.yaml"), encoding="utf-8").read(),
}


@pytest.mark.parametrize("name", sorted(READ_CASES))
def test_load_all_equals_pyyaml(name):
    text = READ_CASES[name]
    # JSON text compares NaN equal, and key order and types (int keys
    # aside) too.
    want = json.dumps(list(yaml.safe_load_all(text)), default=repr)
    assert json.dumps(list(yamlio.safe_load_all(text)), default=repr) == want


@pytest.mark.parametrize("path", corpus_files(), ids=os.path.basename)
def test_corpus_files_load_equal(path):
    with open(path, encoding="utf-8") as f:
        text = f.read()
    assert list(yamlio.safe_load_all(text)) == list(yaml.safe_load_all(text))


@pytest.mark.parametrize("text", ("a: &x 1\nb: *x\n", "!!str a\n", "? complex\n: key\n",
                                  "a: b: c\n", "a: 'open\n", "<<: {a: 1}\n"))
def test_outside_the_subset_raises(text):
    with pytest.raises(yamlio.YAMLError):
        list(yamlio.safe_load_all(text))


def test_load_of_several_documents_raises_like_pyyaml():
    with pytest.raises(yamlio.YAMLError):
        yamlio.safe_load("a: 1\n---\nb: 2\n")
    assert yamlio.safe_load("") is None and yamlio.safe_load("# only\n") is None


def test_config_loads_like_the_jax_package(tmp_path):
    from opsagent_tpu.utils import config as jconfig

    assert pconfig.load_config(os.path.join(REPO, "configs", "config.yaml")) == \
        jconfig.load_config(os.path.join(REPO, "configs", "config.yaml"))
    custom = tmp_path / "c.yaml"
    custom.write_text("jwt:\n  key: k\nlog:\n  level: debug\n  max_size_mb: ~\nextra: [1, 2]\n")
    assert pconfig.load_config(str(custom)) == jconfig.load_config(str(custom))
    assert pconfig.load_config(str(tmp_path / "missing.yaml")) == pconfig.DEFAULTS
    jconfig.reset_config()
    pconfig.reset_config()
