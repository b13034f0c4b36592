"""Full ATLAS ntuple branch catalog (ref tools/ROOT_variables.txt:1-171).

Detector/ntuple metadata constants: the complete list of branches present
in the input ntuples, carried so the ETL can pass through any subset on
request rather than being limited to the ~29 branches the canonical
conversion uses (ref tools/root2h5.py:28-34).  Names are physical branch
identifiers, not code.

``JAGGED`` marks branches that are per-jet lists (vector-typed in the
ntuple); everything else is one value per entry.
"""

WEIGHT_SYSTEMATICS = [
    "weight_mc", "weight_pileup", "weight_leptonSF", "weight_oldTriggerSF",
    "weight_bTagSF_MV2c10_77", "weight_jvt",
    "weight_pileup_UP", "weight_pileup_DOWN",
    "weight_leptonSF_EL_SF_Trigger_UP", "weight_leptonSF_EL_SF_Trigger_DOWN",
    "weight_leptonSF_EL_SF_Reco_UP", "weight_leptonSF_EL_SF_Reco_DOWN",
    "weight_leptonSF_EL_SF_ID_UP", "weight_leptonSF_EL_SF_ID_DOWN",
    "weight_leptonSF_EL_SF_Isol_UP", "weight_leptonSF_EL_SF_Isol_DOWN",
    "weight_leptonSF_MU_SF_Trigger_STAT_UP",
    "weight_leptonSF_MU_SF_Trigger_STAT_DOWN",
    "weight_leptonSF_MU_SF_Trigger_SYST_UP",
    "weight_leptonSF_MU_SF_Trigger_SYST_DOWN",
    "weight_leptonSF_MU_SF_ID_STAT_UP", "weight_leptonSF_MU_SF_ID_STAT_DOWN",
    "weight_leptonSF_MU_SF_ID_SYST_UP", "weight_leptonSF_MU_SF_ID_SYST_DOWN",
    "weight_leptonSF_MU_SF_ID_STAT_LOWPT_UP",
    "weight_leptonSF_MU_SF_ID_STAT_LOWPT_DOWN",
    "weight_leptonSF_MU_SF_ID_SYST_LOWPT_UP",
    "weight_leptonSF_MU_SF_ID_SYST_LOWPT_DOWN",
    "weight_leptonSF_MU_SF_Isol_STAT_UP",
    "weight_leptonSF_MU_SF_Isol_STAT_DOWN",
    "weight_leptonSF_MU_SF_Isol_SYST_UP",
    "weight_leptonSF_MU_SF_Isol_SYST_DOWN",
    "weight_leptonSF_MU_SF_TTVA_STAT_UP",
    "weight_leptonSF_MU_SF_TTVA_STAT_DOWN",
    "weight_leptonSF_MU_SF_TTVA_SYST_UP",
    "weight_leptonSF_MU_SF_TTVA_SYST_DOWN",
    "weight_oldTriggerSF_EL_Trigger_UP", "weight_oldTriggerSF_EL_Trigger_DOWN",
    "weight_oldTriggerSF_MU_Trigger_STAT_UP",
    "weight_oldTriggerSF_MU_Trigger_STAT_DOWN",
    "weight_oldTriggerSF_MU_Trigger_SYST_UP",
    "weight_oldTriggerSF_MU_Trigger_SYST_DOWN",
    "weight_jvt_UP", "weight_jvt_DOWN",
    "weight_bTagSF_MV2c10_77_eigenvars_B_up",
    "weight_bTagSF_MV2c10_77_eigenvars_C_up",
    "weight_bTagSF_MV2c10_77_eigenvars_Light_up",
    "weight_bTagSF_MV2c10_77_eigenvars_B_down",
    "weight_bTagSF_MV2c10_77_eigenvars_C_down",
    "weight_bTagSF_MV2c10_77_eigenvars_Light_down",
    "weight_bTagSF_MV2c10_77_extrapolation_up",
    "weight_bTagSF_MV2c10_77_extrapolation_down",
    "weight_bTagSF_MV2c10_77_extrapolation_from_charm_up",
    "weight_bTagSF_MV2c10_77_extrapolation_from_charm_down",
]

EVENT_LEVEL = [
    "eventNumber", "runNumber", "randomRunNumber", "mcChannelNumber",
    "mu", "mu_actual", "backgroundFlags", "jet_mv2c10", "met_met", "met_phi",
    "dijets", "nbjet77", "NPV", "parton_mjj", "pid1", "pid2",
]

JET_KINEMATICS = [
    "rljet_eta", "rljet_phi", "rljet_m_comb", "rljet_pt_comb",
    "rljet_m_calo", "rljet_pt_calo", "rljet_m_ta", "rljet_pt_ta",
    "rljet_count", "rljet_mjj", "rljet_ptasym", "rljet_mass_asym",
    "rljet_dy", "rljet_dR", "rljet_dphi", "rljet_deta",
]

SUBSTRUCTURE = [
    "rljet_D2", "rljet_Tau32_wta", "rljet_Qw", "rljet_Split23",
    "rljet_C2", "rljet_Tau1_wta", "rljet_Tau2_wta", "rljet_Tau3_wta",
    "rljet_ECF1", "rljet_ECF2", "rljet_ECF3",
    "rljet_FoxWolfram0", "rljet_FoxWolfram2",
    "rljet_Angularity", "rljet_Aplanarity", "rljet_Dip12", "rljet_KtDR",
    "rljet_Mu12", "rljet_PlanarFlow", "rljet_Sphericity",
    "rljet_Split12", "rljet_Split34", "rljet_ThrustMaj", "rljet_ThrustMin",
    "rljet_ZCut12", "rljet_NTrimSubjets", "rljet_ungroomed_ntrk500",
    "rljet_n_constituents",
] + [f"rljet_fractional_pt_{i}" for i in range(10)]

CONSTITUENTS = [
    "rljet_assoc_cluster_pt", "rljet_assoc_cluster_eta",
    "rljet_assoc_cluster_phi",
    "rljet_assoc_track_pt", "rljet_assoc_track_eta", "rljet_assoc_track_phi",
]

TAGGERS = [
    "m_rljet_smooth16Top_Tau32Split23Tag50eff",
    "m_rljet_smooth16Top_Tau32Split23Tag80eff",
    "m_rljet_smooth16Top_MassTau32Tag50eff",
    "m_rljet_smooth16Top_MassTau32Tag80eff",
    "m_rljet_smooth16Top_QwTau32Tag50eff",
    "m_rljet_smooth16Top_QwTau32Tag80eff",
    "rljet_smooth16WTag_50eff", "rljet_smooth16WTag_80eff",
    "rljet_smooth16ZTag_50eff", "rljet_smooth16ZTag_80eff",
    "rljet_smooth19WTag_50eff", "rljet_smooth19WTag_80eff",
    "rljet_smooth19ZTag_50eff", "rljet_smooth19ZTag_80eff",
    "rljet_topTag_BDT_qqb", "rljet_topTag_BDT_qqb_score",
    "rljet_wTag_BDT_qq", "rljet_wTag_BDT_qq_score",
    "rljet_topTag_DNN_qqb_score", "rljet_topTag_DNN_qqb_80",
    "rljet_topTag_DNN19_qqb_score", "rljet_topTag_DNN19_qqb_80",
    "rljet_topTag_DNN19_qqb_50",
    "rljet_topTag_DNN19_inclusive_score", "rljet_topTag_DNN19_inclusive_80",
    "rljet_topTag_DNN19_inclusive_50",
    "rljet_topTag_DNN_sig_based",
    "rljet_wTag_DNN_qq_score", "rljet_wTag_DNN_qq", "rljet_wTag_DNN_qq_80",
    "rljet_wTag_ANN_qq_score", "rljet_wTag_ANN_qq_50",
    "rljet_topTag_TopoTagger_20wp", "rljet_topTag_TopoTagger_50wp",
    "rljet_topTag_TopoTagger_80wp", "rljet_topTag_TopoTagger_score",
]

TRUTH = [
    "rljet_pdgid", "rljet_matched_parton_pt", "rljet_matched_parton_eta",
    "rljet_matched_parton_phi", "rljet_matched_parton_m",
]

CATALOG = (WEIGHT_SYSTEMATICS + EVENT_LEVEL + JET_KINEMATICS + SUBSTRUCTURE
           + CONSTITUENTS + TAGGERS + TRUTH)

JAGGED = set(CONSTITUENTS)


def catalog():
    """The full branch list (171 names, ref tools/ROOT_variables.txt)."""
    return list(CATALOG)
