// The Dormand-Prince 5(4) tableau of the DOPRI5 step kernels, K5 at
// float32 (fused_dopri5.cu) and K5-bf16 (fused_step.cu): the weights of
// ananke_abm_tpu_torch/ode/dopri5.py (_A, _B5, _B5 - _B4, _D), each rounded
// to float32. cA[i][j]: stage i's weight of k_j (0-based); cB5: the
// 5th-order update; cBE: the embedded error; cD: the dense output's r5.
#pragma once

namespace ananke {

__constant__ float cA[7][6] = {
    {0, 0, 0, 0, 0, 0},
    {(float)(1.0 / 5), 0, 0, 0, 0, 0},
    {(float)(3.0 / 40), (float)(9.0 / 40), 0, 0, 0, 0},
    {(float)(44.0 / 45), (float)(-56.0 / 15), (float)(32.0 / 9), 0, 0, 0},
    {(float)(19372.0 / 6561), (float)(-25360.0 / 2187),
     (float)(64448.0 / 6561), (float)(-212.0 / 729), 0, 0},
    {(float)(9017.0 / 3168), (float)(-355.0 / 33), (float)(46732.0 / 5247),
     (float)(49.0 / 176), (float)(-5103.0 / 18656), 0},
    {(float)(35.0 / 384), 0, (float)(500.0 / 1113), (float)(125.0 / 192),
     (float)(-2187.0 / 6784), (float)(11.0 / 84)},
};
__constant__ float cB5[7] = {(float)(35.0 / 384), 0, (float)(500.0 / 1113),
                             (float)(125.0 / 192), (float)(-2187.0 / 6784),
                             (float)(11.0 / 84), 0};
__constant__ float cBE[7] = {
    (float)(35.0 / 384 - 5179.0 / 57600), 0,
    (float)(500.0 / 1113 - 7571.0 / 16695),
    (float)(125.0 / 192 - 393.0 / 640),
    (float)(-2187.0 / 6784 + 92097.0 / 339200),
    (float)(11.0 / 84 - 187.0 / 2100), (float)(-1.0 / 40)};
__constant__ float cD[7] = {
    (float)(-12715105075.0 / 11282082432.0), 0,
    (float)(87487479700.0 / 32700410799.0),
    (float)(-10690763975.0 / 1880347072.0),
    (float)(701980252875.0 / 199316789632.0),
    (float)(-1453857185.0 / 822651844.0),
    (float)(69997945.0 / 29380423.0)};

}  // namespace ananke
