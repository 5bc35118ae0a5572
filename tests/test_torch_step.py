"""The port's G+D step against the JAX package's ``make_train_step`` at
128 px, where enc6's plane is 1x1: its normalised value is exactly 0,
so the activation's derivative at 0 decides the gradient into enc6 and
dec0 (relu' = 0 and leakyrelu' = 1 in both packages). nf=4, batch 2,
dropout off, 1 and 4 steps; losses rtol 2e-3 / atol 2e-4, parameters
after the first step within Adam's sign-flip bound
(tests/test_train_step_parity.py:109-129). The 256-px case is in
test_torch_train.py.
"""

import pytest
import torch

import torch_parity

torch.set_num_threads(2)

CASES = {
    'relu-sigmoid-1class': ('relu', 1, 'sigmoid'),
    'leakyrelu-softmax-3class': ('leakyrelu', 3, 'softmax'),
}


@pytest.mark.parametrize('steps', [1, 4])
@pytest.mark.parametrize('case', sorted(CASES))
def test_train_step_matches_jax_128px(case, steps):
    act, out_c, final_act = CASES[case]
    jl, pl, first = torch_parity.run(128, act, out_c, final_act, steps)
    torch_parity.assert_losses_close(jl, pl)
    jg, jd, tg, td = first
    torch_parity.assert_params_close(jg, tg)
    torch_parity.assert_params_close(jd, td)
