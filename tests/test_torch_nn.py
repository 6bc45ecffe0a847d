"""Layer parity: each ``ttsx_torch.nn`` module against its ``ttsx.nn``
reference on the same numpy inputs and the same (perturbed) weights.

Tolerances: f32 on both sides with sums taken in different orders;
layers agree to ~1e-6 relative, so 1e-5 relative / 1e-5 absolute is
stated unless a test says otherwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.nn.functional as F

from torch_parity_helpers import close, perturb, port, randn, t

RTOL, ATOL = 1e-5, 1e-5


@pytest.mark.parametrize("k,stride,dil,groups,padding,T,cin,cout", [
    (3, 1, 1, 1, "SAME", 9, 8, 6),
    (3, 2, 1, 1, "SAME", 10, 8, 6),
    (3, 2, 1, 1, "SAME", 9, 8, 6),
    (5, 1, 1, 8, "CAUSAL", 12, 8, 8),
    (3, 1, 3, 4, "SAME", 11, 8, 8),
    (7, 1, 1, 1, "VALID", 15, 8, 6),
    (15, 1, 1, 1, "SAME", 7, 4, 2),
])
def test_conv1d_parity(k, stride, dil, groups, padding, T, cin, cout):
    from ttsx.nn.conv import Conv1d as JConv1d
    from ttsx_torch.nn.conv import Conv1d
    x = randn(0, 2, T, cin)
    jm = JConv1d(cout, k, stride=stride, dilation=dil, groups=groups,
                 padding=padding)
    v = perturb(jm.init(jax.random.PRNGKey(0), x))
    ref = jm.apply(v, x)
    m = port(Conv1d(cin, cout, k, stride, dil, groups, padding), v)
    close(m(t(x)), ref, RTOL, ATOL)


@pytest.mark.parametrize("f,T", [(2, 7), (4, 5), (8, 6)])
def test_conv_transpose_parity_and_flip(f, T):
    """The flax [k, Cin, Cout] kernel enters torch's [Cin, Cout, k] layout
    reversed along k: F.conv_transpose1d with the converted weight, cropped
    by f // 2, reproduces flax's ConvTranspose1d."""
    from ttsx.nn.conv import ConvTranspose1d as JConvT
    from ttsx_torch.nn.conv import ConvTranspose1d
    x = randn(1, 2, T, 6)
    jm = JConvT(4, stride=f)
    v = perturb(jm.init(jax.random.PRNGKey(1), x))
    ref = jm.apply(v, x)
    m = port(ConvTranspose1d(6, 4, f), v)
    close(m(t(x)), ref, RTOL, ATOL)
    lib = F.conv_transpose1d(t(x).transpose(1, 2), m.weight, m.bias,
                             stride=f).transpose(1, 2)
    lo = f // 2
    close(lib[:, lo:lo + T * f], ref, RTOL, ATOL)


def test_mhsa_parity():
    from ttsx.nn.attention import MHSA as JMHSA
    from ttsx_torch.nn.attention import MHSA
    x = randn(2, 2, 9, 16)
    q = 2 * x
    jm = JMHSA(4)
    v = perturb(jm.init(jax.random.PRNGKey(2), q, kv=x))
    ref = jm.apply(v, q, kv=x)
    m = port(MHSA(16, 4), v)
    close(m(t(q), t(x)), ref, RTOL, ATOL)


def test_self_attention1d_strided_parity():
    """T=50 over max_attn_len=16: stride 4 subsample and repeat-back."""
    from ttsx.nn.attention import SelfAttention1d as JSA
    from ttsx_torch.nn.attention import SelfAttention1d
    x = randn(3, 2, 50, 16)
    jm = JSA(16, max_attn_len=16)
    v = perturb(jm.init(jax.random.PRNGKey(3), x), scale=0.5)
    ref = jm.apply(v, x)
    m = port(SelfAttention1d(16, max_attn_len=16), v)
    close(m(t(x)), ref, RTOL, ATOL)


def test_conformer_layer_parity():
    from ttsx.nn.conformer import ConformerLayer as JConf
    from ttsx_torch.nn.conformer import ConformerLayer
    x = randn(4, 2, 11, 16)
    jm = JConf(16, num_heads=2, ff_dim=24, kernel_size=5)
    v = perturb(jm.init(jax.random.PRNGKey(4), x, pos_emb=x))
    ref = jm.apply(v, x, pos_emb=x)
    m = port(ConformerLayer(16, 2, 24, 5), v)
    close(m(t(x), pos_emb=t(x)), ref, RTOL, ATOL)


def test_residual_conv_block_parity():
    from ttsx.nn.film import ResidualConvBlock as JBlock
    from ttsx_torch.nn.film import ResidualConvBlock
    x, cond = randn(5, 2, 10, 16), randn(6, 2, 10, 7)
    jm = JBlock(16, 7, kernel_size=5, ls_init=0.5)
    v = perturb(jm.init(jax.random.PRNGKey(5), x, cond))
    ref = jm.apply(v, x, cond)
    m = port(ResidualConvBlock(16, 7, 5), v)
    close(m(t(x), t(cond)), ref, RTOL, ATOL)


@pytest.mark.parametrize("causal,T", [(True, 12), (False, 12), (True, 20)])
def test_s4_fft_parity(causal, T):
    """FFT path (kernel_mode auto); T=20 > l_max=16 takes the tail-extended
    positional bias. FFTs of two libraries: 1e-4 relative / 1e-5 absolute."""
    from ttsx.core.config import S4Config as JS4Config
    from ttsx.nn.s4 import S4 as JS4
    from ttsx_torch.core.config import S4Config
    from ttsx_torch.nn.s4 import S4
    kw = dict(heads=2, l_max=16, causal=causal, norm_groups=2)
    x = randn(7, 2, T, 8)
    jm = JS4(8, JS4Config(**kw))
    v = perturb(jm.init(jax.random.PRNGKey(7), x), scale=0.3)
    ref = jm.apply(v, x)
    m = port(S4(8, S4Config(**kw)), v)
    close(m(t(x)), ref, 1e-4, 1e-5)


def test_gumbel_moe_parity():
    from ttsx.nn.moe import GumbelMoE as JMoE
    from ttsx_torch.nn.moe import GumbelMoE
    x, style = randn(8, 2, 9, 6), randn(9, 2, 5)
    jm = JMoE(6, 10, style_dim=5)
    v = perturb(jm.init(jax.random.PRNGKey(8), x, style))
    ref = jm.apply(v, x, style)
    m = port(GumbelMoE(6, 10, style_dim=5), v)
    close(m(t(x), t(style)), ref, RTOL, ATOL)


def test_tf_block_and_hsf_parity():
    from ttsx.nn.tf_block import HSFLayer as JHSF, TFBlock as JTF
    from ttsx_torch.nn.tf_block import HSFLayer, TFBlock
    x = randn(10, 2, 9, 16)
    jm = JTF(16, heads=4, dim_ff=12)
    v = perturb(jm.init(jax.random.PRNGKey(10), x))
    close(port(TFBlock(16, 4, 12), v)(t(x)), jm.apply(v, x), RTOL, ATOL)
    jh = JHSF(16, 8, 4, 5)
    vh = perturb(jh.init(jax.random.PRNGKey(11), x))
    close(port(HSFLayer(16, 8, 4, 5), vh)(t(x)), jh.apply(vh, x), RTOL, ATOL)


def test_hier_vq_parity_uses_vq_stats():
    """The codebook is embed_sum / max(cluster_size, eps) from the
    vq_stats collection; cluster sizes drawn away from 1 make the
    division matter, so a port that ignored them would disagree."""
    from ttsx.nn.vq import HierVQ as JVQ
    from ttsx_torch.nn.vq import HierVQ
    x = randn(12, 2, 9, 6, scale=2.0)
    jm = JVQ((6, 6), (16, 16))
    v = jax.tree_util.tree_map(np.asarray,
                               jm.init(jax.random.PRNGKey(12), x))
    rng = np.random.default_rng(12)
    for st in v["vq_stats"].values():
        st["cluster_size"] = rng.uniform(0.5, 3.0, st["cluster_size"].shape
                                         ).astype(np.float32)
    ref, _ = jm.apply(v, x)
    got = port(HierVQ((6, 6), (16, 16)), v)(t(x))
    close(got, ref, RTOL, ATOL)
    assert not np.allclose(np.asarray(ref), x)


def test_gst_parity():
    from ttsx.nn.gst import GlobalStyleTokens as JGST
    from ttsx_torch.nn.gst import GlobalStyleTokens
    mel = randn(13, 2, 12, 10)
    jm = JGST(10, 8, 5)
    v = perturb(jm.init(jax.random.PRNGKey(13), mel))
    close(port(GlobalStyleTokens(10, 8, 5), v)(t(mel)), jm.apply(v, mel),
          RTOL, ATOL)


def test_embed_parity():
    from ttsx.nn.embed import rotary_mix as j_rotary, sinusoidal_table as j_tab
    from ttsx_torch.nn.embed import rotary_mix, sinusoidal_table
    np.testing.assert_array_equal(sinusoidal_table(20, 12), j_tab(20, 12))
    x = randn(14, 2, 30, 12)
    close(rotary_mix(t(x)), j_rotary(jnp.asarray(x)), RTOL, ATOL)
