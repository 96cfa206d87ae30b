"""The paper's analysis layer, copied from ``repro.core`` so the port
imports nothing of ``repro``: hardware (Table 5), modelspec (Table 4),
budget (Eqs. 1-8), comm_roofline (Eqs. 9-10), hfu_bound (Fig. 4),
imbalance (Eqs. 11-16), planner (§4 as policy, and the Eq. 9/17 wire
model the serving engine checks its measured bytes against) and overlap
(the §2.2 batch-overlap pipeline simulator)."""
