"""Ball Sparse Attention: the port's public API (counterpart of
``repro.core``).

  * :class:`BSAConfig`: the paper's hyperparameters (ball size m,
    compression block ℓ, top-k k*, group size g, gating) and the backend
    knobs (``backend``, ``backend_overrides``).
  * Attention backends (``repro_torch.core.backend``): a named registry,
    ``"reference"`` (plain PyTorch on any device), ``"kernels"`` (the
    hand-written CUDA kernels; their plain versions on CPU tensors) and
    ``"auto"`` (by the tensors' device), chosen by ``BSAConfig.backend``,
    scoped by ``with use_backend("..."):``, forced process-wide by
    ``$REPRO_TORCH_ATTENTION_BACKEND`` and extended by
    :func:`register_backend`.
  * :func:`bsa_attention` / :func:`bsa_init`: non-causal BSA on
    ball-ordered point sequences.  q: (B, N, Hq, D); k, v: (B, N, Hkv, D),
    Hq = Hkv·rep; ``mask``: (B, N) bool, True = real token.
  * :func:`bsa_attention_varlen`: BSA over a packed batch, all samples on
    one (T, H, D) axis with host ``offsets``.
  * :func:`nsa_causal_attention` / :func:`nsa_init`: the causal 1-D form
    (the LM), with :func:`init_decode_cache` / :func:`nsa_causal_decode`
    and the paged :func:`init_paged_decode_cache` /
    :func:`nsa_causal_decode_paged`.
  * :func:`full_attention`, :func:`erwin_attention`: the paper's baselines.
  * The ball-order and batching helpers of ``repro_torch.core.balltree``
    (host numpy).

Names of ``repro.core`` and their counterparts here:

  ``JnpBackend``     → :class:`ReferenceBackend` (registered ``"reference"``)
  ``PallasBackend``  → :class:`KernelBackend` (registered ``"kernels"``)
  ``Backend``        → none: a backend is any object with the ops of
                       ``backend.REQUIRED_OPS``, which
                       :func:`register_backend` checks
  every other name   → the same name

The ``"sharded"`` backend (``repro_torch.distributed``: the ops split
across the ranks of a ``torch.distributed`` mesh, activated by
``mesh_context``) registers itself the first time ``get_backend`` or
``use_backend`` names it, as JAX's does.  Training across ranks (the
parameter shardings of ``repro.distributed.params``) is still to come:
ROADMAP queue 1 item 3.
"""

from repro_torch.core.config import BSAConfig  # noqa: F401
from repro_torch.core.backend import (  # noqa: F401
    KernelBackend,
    ReferenceBackend,
    get_backend,
    list_backends,
    register_backend,
    resolve_backend,
    use_backend,
)
from repro_torch.core.bsa import (  # noqa: F401
    ball_attention_ref,
    bsa_attention,
    bsa_attention_varlen,
    bsa_init,
)
from repro_torch.core.nsa_causal import (  # noqa: F401
    init_decode_cache,
    init_paged_decode_cache,
    nsa_causal_attention,
    nsa_causal_decode,
    nsa_causal_decode_paged,
    nsa_init,
)
from repro_torch.core.full_attention import full_attention  # noqa: F401
from repro_torch.core.erwin import erwin_attention  # noqa: F401
from repro_torch.core.balltree import (  # noqa: F401
    ball_order,
    bucket_length,
    build_balltree_permutation,
    build_balltree_permutations,
    pack_ragged,
    pack_varlen,
    pad_to_multiple,
    ragged_ball_order,
    unpack_ragged,
    unpack_varlen,
)
