"""The port's data pipeline and tokenizer against the reference's: the
pipeline is pure numpy in both packages, so batches must be bitwise equal
for the same seed — token mode, embed mode with 4 codebooks (musicgen),
the VLM's image embeddings (llama-3.2-vision) and a text corpus."""
import pytest

torch = pytest.importorskip("torch")

import itertools  # noqa: E402

import numpy as np  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.data import ByteTokenizer as JByteTokenizer  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import LMDataPipeline as JLMDataPipeline  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.data import ByteTokenizer, DataConfig, LMDataPipeline  # noqa: E402

MODES = {
    "token": ("qwen1.5-0.5b", False),
    "embed_codebooks": ("musicgen-medium", False),
    "vlm_images": ("llama-3.2-vision-90b", False),
    "text": ("qwen1.5-0.5b", True),
}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
def test_pipeline_batches_bitwise_equal_reference(mode, full, tmp_path):
    arch, text = MODES[mode]
    cfg, jcfg = get_config(arch), j_get_config(arch)
    if not full:
        cfg, jcfg = reduced(cfg), j_reduced(jcfg)
    path = None
    if text:
        path = tmp_path / "corpus.txt"
        path.write_text("Galaxy: collaborative edge inference. " * 40)
        path = str(path)
    kw = dict(batch_size=3, seq_len=24, seed=5, text_path=path, process_index=1)
    ours = LMDataPipeline(cfg, DataConfig(**kw))
    ref = JLMDataPipeline(jcfg, JDataConfig(**kw))
    for got, want in itertools.islice(zip(ours, ref), 3):
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    keys = {"token": {"tokens", "labels"}, "text": {"tokens", "labels"},
            "embed_codebooks": {"embeds", "labels"},
            "vlm_images": {"tokens", "labels", "img_embeds"}}[mode]
    assert set(got) == keys
    if mode == "embed_codebooks":
        assert got["labels"].shape == (3, 24, 4) and got["embeds"].shape == (3, 24, cfg.d_model)
    if mode == "vlm_images":
        assert got["img_embeds"].shape == (3, cfg.num_image_tokens, cfg.d_model)


def test_tokenizer_round_trip_and_ids():
    tok, ref = ByteTokenizer(), JByteTokenizer()
    text = "Galaxy — edge AI, naïve café ✓"
    for bos in (False, True):
        for eos in (False, True):
            ids = tok.encode(text, add_bos=bos, add_eos=eos)
            assert ids == ref.encode(text, add_bos=bos, add_eos=eos)
            assert tok.decode(ids) == ref.decode(ids) == text
    assert (tok.vocab_size, tok.pad_id, tok.bos_id, tok.eos_id) == (
        ref.vocab_size, ref.pad_id, ref.bos_id, ref.eos_id) == (259, 256, 257, 258)
