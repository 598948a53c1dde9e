"""The tiny agent's training rows, committed as ``tests/fixtures/tiny-agent-train.npz``.

The rows are those ``scripts/train_tiny_agent.py``'s ``build_dataset``
makes over the three system-prompt contexts that trained
``tests/fixtures/tiny-agent-hf`` (its ``SYS_PROMPT``, the ReAct and the
execute prompts), tokenized by that fixture's tokenizer: ``tokens`` int32
[N, S] right-padded with the pad id to a multiple of 8, ``mask`` f32 (1 on
the reply tokens), and the recipe of ``train_checkpoint`` (``lr``,
``target_loss``, ``max_steps``, ``check_every``, ``weight_decay``). The
port trains from the file on the card, where neither the JAX package nor
``tokenizers`` is. The test rebuilds the rows and holds the file to them,
so it cannot go stale. Rebuild it with
``JAX_PLATFORMS=cpu python tests/test_torch_train_data.py``.
"""

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "tiny-agent-train.npz")
AGENT = os.path.join(REPO, "tests", "fixtures", "tiny-agent-hf")
RECIPE = dict(lr=3e-3, target_loss=0.01, max_steps=600, check_every=50, weight_decay=0.0)


def build_rows() -> dict[str, np.ndarray]:
    sys.path[:0] = [os.path.join(REPO, "scripts")]
    try:
        import train_tiny_agent as t
    finally:
        sys.path.remove(os.path.join(REPO, "scripts"))
    from opsagent_tpu.agent.prompts import EXECUTE_SYSTEM_PROMPT_CN, REACT_SYSTEM_PROMPT
    from opsagent_tpu.serving.tokenizer import load_tokenizer

    prefix = "Here are the instructions: "
    contexts = [(t.SYS_PROMPT, prefix), (REACT_SYSTEM_PROMPT, prefix),
                (EXECUTE_SYSTEM_PROMPT_CN, "")]
    base = t.build_convs

    def build_convs(tasks=None):
        out = []
        for messages, reply in base(tasks):
            for system, user in contexts:
                m = [dict(x) for x in messages]
                m[0]["content"] = system
                m[1]["content"] = user + m[1]["content"][len(prefix):]
                out.append((m, reply))
        return out

    tok = load_tokenizer(AGENT)
    t.build_convs = build_convs
    try:
        rows = t.build_dataset(tok, t.TASKS_SINGLE)
    finally:
        t.build_convs = base
    S = 8 * ((max(len(ids) for ids, _ in rows) + 7) // 8)
    tokens = np.full((len(rows), S), tok.pad_id, np.int32)
    mask = np.zeros((len(rows), S), np.float32)
    for i, (ids, m) in enumerate(rows):
        tokens[i, : len(ids)] = ids
        mask[i, : len(m)] = m
    return {"tokens": tokens, "mask": mask,
            **{k: np.asarray(v) for k, v in RECIPE.items()}}


def test_fixture_equals_the_rebuilt_rows():
    want = build_rows()
    with np.load(FIXTURE) as got:
        assert sorted(got.files) == sorted(want)
        for key, a in want.items():
            assert got[key].dtype == a.dtype, key
            np.testing.assert_array_equal(got[key], a, err_msg=key)
    assert want["tokens"].shape[0] == 6 and want["mask"].sum() > 0


if __name__ == "__main__":
    np.savez_compressed(FIXTURE, **build_rows())
    print(FIXTURE)
